"""PyTorch port, whole model: reduced yi-6b and gemma-2b (head_dim = 64, so
the reference really runs its Pallas kernels) with the same weights, carried
across by `convert.load_jax_params`.  Logits of `dense`, `prefill` and three
`decode` steps agree within 1e-4 at `double` (fp32 everywhere; two layers of
reordered sums) and, at `half`, within 2e-2 of the logit scale (bf16 keeps 8
bits: one rounding that falls the other way upstream moves a logit by an ulp
or two of the largest logits); caches agree after each step, and the batched
serving layout of `stack_caches` is the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jbuild
from repro.models.registry import reduced_config as jreduced
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro_torch.convert import cache_from_numpy, cache_to_numpy, load_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.registry import reduced_config as treduced
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx
from repro_torch.nn.module import init_params as tinit
from repro_torch.nn.module import param_count, param_tree

from _torch_port import assert_tree_close, np_tree, t, to_np

torch.set_num_threads(1)

TOLS = {"double": dict(atol=1e-4, rtol=1e-4), "half": dict(atol=2e-2, rtol=2e-2)}
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16, "rms_block_rows": 8,
         "cache_max_len": 24}


def _models(arch, policy):
    jcfg = jreduced(arch).replace(head_dim=64)
    tcfg = treduced(arch).replace(head_dim=64)
    assert jcfg == type(jcfg)(**vars(tcfg))  # the copied config says the same
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    jparams = jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default(policy))
    tinit(tmodel, 0, TPolicies.default(policy), "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    jctx = JCtx(policies=JPolicies.default(policy), extra=EXTRA,
                impls=[("*", "attention", "pallas"), ("*", "norm", "pallas")])
    tctx = TCtx(policies=TPolicies.default(policy), extra=EXTRA,
                impls=[("*", "attention", "cuda"), ("*", "norm", "cuda")])
    return jmodel, tmodel, jparams, tparams, jctx, tctx


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_logits_and_caches_match_reference(arch, policy):
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models(arch, policy)
    tol = TOLS[policy]

    def close(got, want):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max())) if policy == "half" else 1.0
        np.testing.assert_allclose(to_np(got), want, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)

    tokens = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)

    want, _ = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="dense")
    got, none = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="dense")
    assert none is None and got.shape == (2, 12, 512)
    close(got, want)

    want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="prefill")
    got, tcache = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="prefill")
    assert got.shape == (2, 1, 512)
    close(got, want)
    assert_tree_close(tcache, np_tree(jcache), **tol)

    for step in range(3):
        tok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        pos = np.full((2, 1), 12 + step, np.int32)
        want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                              ctx=jctx, mode="decode", cache=jcache)
        got, tcache = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                             ctx=tctx, mode="decode", cache=tcache)
        close(got, want)
        assert_tree_close(tcache, np_tree(jcache), **tol)


def test_decode_from_a_converted_cache():
    """A reference prefill cache carried across by `cache_from_numpy` decodes
    to the reference's logits: the two cache layouts are the same layout."""
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models("yi-6b", "double")
    tokens = np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    logits, jcache = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="prefill")
    tcache = cache_from_numpy(np_tree(jcache))
    assert_tree_close(tcache, cache_to_numpy(tcache), atol=0, rtol=0)
    tok = np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)
    pos = np.full((2, 1), 9, np.int32)
    want, _ = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                     ctx=jctx, mode="decode", cache=jcache)
    got, _ = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                    ctx=tctx, mode="decode", cache=tcache)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOLS["double"])


@pytest.mark.parametrize("arch,window", [("yi-6b", None), ("yi-6b", 8)])
def test_stack_caches_layout_matches_reference(arch, window):
    """Per-request prefill caches of different lengths stacked into the
    serving layout (per-request `index`; ring `pos` under a window), then one
    batched decode step."""
    jcfg = jreduced(arch).replace(head_dim=64, attn_window=window)
    tcfg = treduced(arch).replace(head_dim=64, attn_window=window)
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    jparams = jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default("double"))
    tinit(tmodel, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    jctx = JCtx(policies=JPolicies.default("double"), extra=EXTRA)
    tctx = TCtx(policies=TPolicies.default("double"), extra=EXTRA)
    rng = np.random.default_rng(2)
    jcs, tcs, lens = [], [], (9, 11, 14)  # all past the window: ring caches
    for n in lens:
        tokens = rng.integers(0, 512, (1, n)).astype(np.int32)
        jcs.append(jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="prefill")[1])
        tcs.append(tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="prefill")[1])
    jcache, tcache = jmodel.stack_caches(jcs), tmodel.stack_caches(tcs)
    assert_tree_close(tcache, np_tree(jcache), atol=1e-4, rtol=1e-4)
    assert tcache["blocks0"]["index"].shape == (2, 3)
    assert ("pos" in tcache["blocks0"]) == (window is not None)
    tok = rng.integers(0, 512, (3, 1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)[:, None]
    want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                          ctx=jctx, mode="decode", cache=jcache)
    got, tcache = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                         ctx=tctx, mode="decode", cache=tcache)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert_tree_close(tcache, np_tree(jcache), atol=1e-4, rtol=1e-4)


def test_init_cache_and_specs_match_reference():
    jmodel = jbuild(jreduced("yi-6b"))
    tmodel = tbuild(treduced("yi-6b"))
    want = np_tree(jmodel.init_cache(2, 16, index=5))
    got = tmodel.init_cache(2, 16, index=5)
    # the reference zero-fills in bf16; compare values and shapes
    assert_tree_close(got, want, atol=0, rtol=0)
    specs = tmodel.cache_specs(2, 16)
    jspecs = jmodel.cache_specs(2, 16)
    assert specs["kv_pos"][0] == jspecs["kv_pos"].shape
    for key, (shape, _) in specs["blocks0"].items():
        assert shape == jspecs["blocks0"][key].shape


def test_state_dict_keys_are_reference_paths():
    """`state_dict()` keys are the reference's param-tree paths joined by
    "." — one stacked (L, ...) parameter per leaf of the layer stack."""
    jmodel, tmodel = jbuild(jreduced("gemma-2b")), tbuild(treduced("gemma-2b"))
    jparams = jinit(jmodel, jax.random.PRNGKey(0))
    tinit(tmodel, 0, None, "cpu")

    def paths(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from paths(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", tuple(v.shape)

    want = dict(paths(jparams))
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert got["blocks0.block.attn.wq"][0] == 2  # the leading layer dim
    assert dict(paths(param_tree(tmodel))) == want
    assert param_count(tmodel) == sum(int(np.prod(s)) for s in want.values())


def test_vlm_and_encdec_families_and_meshes_raise():
    """A mesh still raises.  The vision-language and encoder-decoder
    families, ported with ROADMAP Queue 1 item 10b, no longer do: a minimal
    config of each builds (`test_vlm_and_encdec_families_build` runs them)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import TransformerLM

    for family, cls in (("vlm", TransformerLM), ("encdec", EncDecLM)):
        cfg = ModelConfig(name="m", family=family, num_layers=1, d_model=8, n_heads=1,
                          kv_heads=1, d_ff=8, vocab=8)
        assert type(tbuild(cfg)) is cls
    with pytest.raises(NotImplementedError, match="mesh"):
        TCtx(mesh=object())


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-small"])
def test_vlm_and_encdec_families_build(arch):
    """Both families build from their reduced configs and run a dense
    forward over their frontend stub's input (`embeds` / `frames`), with the
    reference's param tree paths and shapes."""
    cfg = treduced(arch)
    model = tbuild(cfg)
    params = tinit(model, 0, None, "cpu")
    jparams = jinit(jbuild(jreduced(arch)), jax.random.PRNGKey(0))
    load_jax_params(model, np_tree(jparams))
    rng = np.random.default_rng(0)
    inputs = {"tokens": t(rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32))}
    stub = "embeds" if cfg.family == "vlm" else "frames"
    n = cfg.num_image_tokens if cfg.family == "vlm" else 10
    inputs[stub] = t(rng.standard_normal((2, n, cfg.d_model)).astype(np.float32), torch.bfloat16)
    logits, _ = model(params, inputs, ctx=TCtx(), mode="dense")
    extra = n if cfg.family == "vlm" else 0
    assert logits.shape == (2, 6 + extra, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
