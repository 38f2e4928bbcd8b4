"""PyTorch port, the recurrent families whole: reduced recurrentgemma-2b and
rwkv6-3b with the reference's weights carried across by
`convert.load_jax_params`, policy `double` (fp32 everywhere).

- logits (dense, prefill), caches and four decode steps within 1e-4, with the
  kernels woven (the reference's Pallas kernels in interpret mode; the
  port's CUDA kernels, whose wrappers take the plain versions for CPU
  tensors) and without;
- greedy tokens of `serve` / `serve_batch` equal to the reference server's,
  and inside the port `serve_batch` equal to solo `serve`, also for a
  hybrid batch mixing prompts shorter and longer than the window, which the
  reference cannot stack;
- what the reference refuses, the port refuses: paged serving of recurrent
  state."""

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
from repro.models.registry import reduced_config as jreduced
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.convert import cache_from_numpy, cache_to_numpy, load_jax_params
from repro_torch.core.program import Program as TProgram
from repro_torch.launch.weave import cuda_kernel_aspects
from repro_torch.launch.weave import default_weave as tweave
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.registry import reduced_config as treduced
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx
from repro_torch.nn.module import init_params as tinit
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig

from _torch_port import assert_tree_close, np_tree, perturbed, t, to_np

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 everywhere; reordered sums only
JIMPLS = [("*", "attention", "pallas"), ("*", "norm", "pallas"),
          ("*", "rglru", "pallas"), ("*", "wkv", "pallas")]
TIMPLS = [("*", "attention", "cuda"), ("*", "norm", "cuda"),
          ("*", "rglru", "cuda"), ("*", "wkv", "cuda")]
EXTRA = {"rglru_block_d": 8, "rglru_chunk": 16, "wkv_chunk": 16, "cache_max_len": 24}
ARCHS = ["recurrentgemma-2b", "rwkv6-3b"]


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOL)


def _jitted(jmodel, jctx):
    """The reference model as one compiled function per mode: op-by-op
    dispatch compiles every op anew for every sequence length."""
    fns = {}

    def run(params, inputs, *, mode, cache=None):
        if mode not in fns:
            fns[mode] = jax.jit(lambda p, i, c, _m=mode: jmodel(p, i, ctx=jctx, mode=_m, cache=c))
        return fns[mode](params, inputs, cache)

    run.stack_caches = jmodel.stack_caches
    return run


def _models(arch, impls=True):
    jcfg, tcfg = jreduced(arch), treduced(arch)
    assert jcfg == type(jcfg)(**vars(tcfg))  # the copied config says the same
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg)
    jparams = jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default("double"))
    jparams = perturbed(jparams, 7)
    tinit(tmodel, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tmodel, jparams)
    jctx = JCtx(policies=JPolicies.default("double"), extra=EXTRA,
                impls=JIMPLS if impls else [])
    tctx = TCtx(policies=TPolicies.default("double"), extra=EXTRA,
                impls=TIMPLS if impls else [])
    return _jitted(jmodel, jctx), tmodel, jax.tree.map(jnp.asarray, jparams), tparams, \
        jctx, tctx


@pytest.mark.parametrize("impls", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_caches_and_decode_match_reference(arch, impls):
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models(arch, impls)
    # past the hybrid's reduced window of 16: its attention caches are rings
    tokens = _rng(0).integers(0, 512, (2, 20)).astype(np.int32)

    want, _ = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, mode="dense")
    got, none = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="dense")
    assert none is None and got.shape == (2, 20, 512)
    _close(got, want)

    want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, mode="prefill")
    got, tcache = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="prefill")
    _close(got, want)
    assert_tree_close(tcache, np_tree(jcache), **TOL)

    for step in range(4):
        tok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        pos = np.full((2, 1), 20 + step, np.int32)
        want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                              mode="decode", cache=jcache)
        got, tcache = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                             ctx=tctx, mode="decode", cache=tcache)
        _close(got, want)
        assert_tree_close(tcache, np_tree(jcache), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_a_converted_cache(arch):
    """A reference prefill cache (recurrent state included) carried across
    by `cache_from_numpy` decodes to the reference's logits."""
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models(arch, impls=False)
    tokens = _rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    logits, jcache = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, mode="prefill")
    tcache = cache_from_numpy(np_tree(jcache), dtype=torch.bfloat16)
    for path, leaf in _leaves(tcache):
        if path[-1] in ("lru", "x_prev", "wkv"):
            assert leaf.dtype == torch.float32, path
        elif path[-1] in ("conv", "k", "v"):
            assert leaf.dtype == torch.bfloat16, path
    tcache = cache_from_numpy(np_tree(jcache))
    assert_tree_close(tcache, cache_to_numpy(tcache), atol=0, rtol=0)
    tok = np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)
    pos = np.full((2, 1), 9, np.int32)
    want, _ = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                     mode="decode", cache=jcache)
    got, _ = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                    ctx=tctx, mode="decode", cache=tcache)
    _close(got, want)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_init_cache_and_params_match_reference(arch):
    jmodel, tmodel = jbuild(jreduced(arch)), tbuild(treduced(arch))
    for cache_len in (8, 24):  # the hybrid's window of 16: linear, then ring
        want = np_tree(jmodel.init_cache(2, cache_len, index=5))
        got = tmodel.init_cache(2, cache_len, index=5)
        assert_tree_close(got, want, atol=0, rtol=0)
        jspecs = jmodel.cache_specs(2, cache_len)
        specs = tmodel.cache_specs(2, cache_len)
        for path, (shape, dtype) in _leaves_specs(specs):
            sds = _get(jspecs, path)
            assert shape == sds.shape and str(dtype).split(".")[-1] == str(sds.dtype), path
    jparams = jinit(jmodel, jax.random.PRNGKey(0))
    tinit(tmodel, 0, None, "cpu")
    want = {".".join(p): tuple(v.shape) for p, v in _leaves(np_tree(jparams))}
    assert {k: tuple(v.shape) for k, v in tmodel.state_dict().items()} == want
    if arch == "recurrentgemma-2b":
        assert "layer02.attn.wq" in want and "layer00.rec.rglru.lam" in want
    else:
        assert "ln0.w" in want and "head.w" in want
        assert want["blocks0.block.time_mix.maa_w2"] == (2, 5, 32, 64)


def _leaves_specs(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_specs(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_caches_layout_matches_reference(arch):
    """Per-request prefill caches of different lengths stacked into the
    serving layout, then one batched decode step, against the reference.
    All the hybrid's prompts here are past its window: ring caches."""
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models(arch, impls=False)
    rng = _rng(2)
    jcs, tcs, lens = [], [], (17, 19, 22)
    for n in lens:
        tokens = rng.integers(0, 512, (1, n)).astype(np.int32)
        jcs.append(jmodel(jparams, {"tokens": jnp.asarray(tokens)}, mode="prefill")[1])
        tcs.append(tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="prefill")[1])
    jcache, tcache = jmodel.stack_caches(jcs), tmodel.stack_caches(tcs)
    assert_tree_close(tcache, np_tree(jcache), **TOL)
    tok = rng.integers(0, 512, (3, 1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)[:, None]
    want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                          mode="decode", cache=jcache)
    got, tcache = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                         ctx=tctx, mode="decode", cache=tcache)
    _close(got, want)
    assert_tree_close(tcache, np_tree(jcache), **TOL)


def test_mixed_linear_and_ring_caches_stack_in_the_ring_layout():
    """A hybrid batch with prompts shorter and longer than the window: the
    reference cannot concatenate the linear and the ring layouts; the port
    joins the linear caches as rings, and each request's decode logits equal
    its own solo decode."""
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models("recurrentgemma-2b", impls=False)
    rng = _rng(3)
    prompts = [rng.integers(0, 512, (1, n)).astype(np.int32) for n in (5, 20, 11)]
    jcs = [jmodel(jparams, {"tokens": jnp.asarray(p)}, mode="prefill")[1]
           for p in prompts]
    with pytest.raises(TypeError):
        jmodel.stack_caches(jcs)
    tcs = [tmodel(tparams, {"tokens": t(p)}, ctx=tctx, mode="prefill")[1] for p in prompts]
    tok = rng.integers(0, 512, (3, 1)).astype(np.int32)
    solo = []
    for p, c, b in zip(prompts, tcs, range(3)):
        pos = np.full((1, 1), p.shape[1], np.int32)
        want, _ = jmodel(jparams, {"tokens": jnp.asarray(tok[b:b + 1]),
                                   "positions": jnp.asarray(pos)},
                         mode="decode", cache=jcs[b])
        solo.append(np.asarray(want))
    stacked = tmodel.stack_caches(tcs)
    assert "kv_pos" not in stacked
    attn = stacked["layer02"]
    assert attn["pos"].shape == (3, 16) and attn["index"].tolist() == [5, 20, 11]
    assert attn["pos"][0].tolist() == list(range(5)) + [-1] * 11
    pos = np.asarray([[5], [20], [11]], np.int32)
    got, _ = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                    ctx=tctx, mode="decode", cache=stacked)
    for b in range(3):
        np.testing.assert_allclose(to_np(got[b:b + 1]), solo[b], **TOL)


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------


def _servers(arch):
    """Both servers, built as the launchers build them (the reference woven
    to its Pallas kernels, the port to its CUDA kernels), policy `double`,
    the port's weights overwritten from the reference server's."""
    jprog = JProgram.from_arch(arch, kind="serve", reduced=True)
    tprog = TProgram.from_arch(arch, kind="serve", reduced=True, device="cpu")
    over = {"wkv_chunk": 16}
    jwoven = jweave(jprog, JSHAPES["prefill_32k"], {}, overrides=dict(over),
                    extra_aspects=[JKernelAspect(*i) for i in JIMPLS])
    twoven = tweave(tprog, TSHAPES["prefill_32k"], {}, overrides=dict(over),
                    extra_aspects=cuda_kernel_aspects())
    jwoven.state.policies = JPolicies.default("double")
    twoven.state.policies = TPolicies.default("double")
    jsrv = JServer(jwoven, JServerConfig(max_cache_len=24, decode_tokens=4))
    tsrv = TServer(twoven, TServerConfig(max_cache_len=24, decode_tokens=4))
    load_jax_params(tprog.model, np_tree(jsrv.params))
    return jsrv, tsrv


# the batched-server prompts of tests/test_flash_decode.py:630-641
PROMPTS = [np.ones((5,), np.int32), (np.arange(1, 9) % 50).astype(np.int32),
           np.full((3,), 7, np.int32)]
LONG = (np.arange(19) * 7 % 61).astype(np.int32)  # past the hybrid's window of 16


@pytest.fixture(scope="module", params=ARCHS)
def servers(request):
    return request.param, _servers(request.param)


def test_serve_and_serve_batch_tokens_equal_reference(servers):
    arch, (jsrv, tsrv) = servers
    assert [i[1:] for i in tsrv.woven.state.impls] == [i[1:] for i in TIMPLS]
    for p in PROMPTS + [LONG]:
        np.testing.assert_array_equal(tsrv.serve(p[None]), jsrv.serve(p[None]))
    prompt = _rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(tsrv.serve(prompt), jsrv.serve(prompt))
    for batch in (PROMPTS, [LONG, LONG[:17]]):  # all linear, all rings
        for g, w in zip(tsrv.serve_batch(batch), jsrv.serve_batch(batch)):
            np.testing.assert_array_equal(g, w)


def test_serve_batch_equals_solo_serve_inside_the_port(servers):
    """Including a batch that mixes the hybrid's linear and ring caches,
    which the reference cannot stack."""
    _, (_, tsrv) = servers
    batch = PROMPTS + [LONG]
    got = tsrv.serve_batch(batch)
    assert len(got) == 4
    for p, g in zip(batch, got):
        np.testing.assert_array_equal(g, tsrv.serve(p[None])[0])


def test_paged_serving_refuses_recurrent_state(servers):
    """As the reference does (`test_paged_serving.py::test_ssm_family_raises`):
    the recurrent state is not paged."""
    arch, (jsrv, tsrv) = servers
    with pytest.raises(ValueError, match="not paged-compatible"):
        jsrv.serve_continuous([np.ones((4,), np.int32)])
    with pytest.raises(ValueError, match="not paged-compatible"):
        tsrv.serve_continuous([np.ones((4,), np.int32)])
    with pytest.raises(ValueError, match="not paged-compatible"):
        next(tsrv.serve_stream([np.ones((4,), np.int32)]))
    assert tsrv.last_pool_stats is None


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["--continuous", "--stream"])
def test_launcher_refuses_paged_modes_for_recurrent_archs(arch, mode, capsys):
    from repro_torch.launch import serve as launcher

    with pytest.raises(SystemExit) as exc:
        launcher.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                       "--prompt-len", "4", "--decode-tokens", "2", mode])
    assert exc.value.code == 2
    assert "not paged-compatible" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_recurrent_archs_on_cpu(arch, capsys):
    from repro_torch.launch import serve as launcher

    assert launcher.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                          "--prompt-len", "20", "--decode-tokens", "2"]) == 0
    assert launcher.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                          "--prompt-len", "6", "--decode-tokens", "2",
                          "--batch-serve"]) == 0
    assert "batched wave: 2 request(s)" in capsys.readouterr().out
