"""PyTorch port, the slice as a whole: `Program.from_arch` -> `default_weave`
(+ kernel aspects) -> `Server` in both packages, the port's weights
overwritten from the reference server's params, precision `double`.  Greedy
tokens of `serve` and `serve_batch` are equal between the packages; inside
the port `serve_batch` equals solo `serve`, a memoised second call hits, and
the weave reports of the two packages agree per shared aspect."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import KernelAspect as JKernelAspect
from repro.launch.weave import default_weave as jweave
from repro.models.registry import build_model as jbuild
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program as TProgram
from repro_torch.launch.weave import cuda_kernel_aspects
from repro_torch.launch.weave import default_weave as tweave
from repro_torch.memo.table import MemoTable
from repro_torch.models.registry import build_model as tbuild
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig

from _torch_port import np_tree

torch.set_num_threads(1)

OVERRIDES = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16}


def _servers(arch, head_dim=None):
    """Both servers, built the way the launchers build them.  `head_dim=64`
    swaps in the variant of the reduced config whose attention reaches the
    kernels (the reduced default, 16, stays on the plain path in both)."""
    jprog = JProgram.from_arch(arch, kind="serve", reduced=True)
    tprog = TProgram.from_arch(arch, kind="serve", reduced=True, device="cpu")
    if head_dim is not None:
        jcfg = jprog.cfg.replace(head_dim=head_dim)
        tcfg = tprog.cfg.replace(head_dim=head_dim)
        jprog = dataclasses.replace(jprog, cfg=jcfg, model=jbuild(jcfg))
        tprog = dataclasses.replace(tprog, cfg=tcfg, model=tbuild(tcfg))
    jwoven = jweave(jprog, JSHAPES["prefill_32k"], {}, overrides=dict(OVERRIDES),
                    extra_aspects=[JKernelAspect("*", "attention", "pallas"),
                                   JKernelAspect("*", "norm", "pallas"),
                                   JKernelAspect("*", "rglru", "pallas"),
                                   JKernelAspect("*", "wkv", "pallas")])
    twoven = tweave(tprog, TSHAPES["prefill_32k"], {}, overrides=dict(OVERRIDES),
                    extra_aspects=cuda_kernel_aspects())
    # `double` is set on the woven state itself: a woven ChangePrecision("*")
    # roots its patterns at the model's name, which the scopes a forward pass
    # enters do not carry, so in both packages it retypes the parameters but
    # leaves the compute in bf16 — and bf16 logits tie.
    jwoven.state.policies = JPolicies.default("double")
    twoven.state.policies = TPolicies.default("double")
    jsrv = JServer(jwoven, JServerConfig(max_cache_len=24, decode_tokens=4))
    tsrv = TServer(twoven, TServerConfig(max_cache_len=24, decode_tokens=4))
    load_jax_params(tprog.model, np_tree(jsrv.params))
    return jsrv, tsrv


PROMPTS = [np.ones((5,), np.int32), (np.arange(1, 9) % 50).astype(np.int32),
           np.full((3,), 7, np.int32)]


@pytest.fixture(scope="module")
def yi64():
    return _servers("yi-6b", head_dim=64)


def test_serve_tokens_equal_reference(yi64):
    jsrv, tsrv = yi64
    prompt = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    want = jsrv.serve(prompt)
    got = tsrv.serve(prompt)
    assert got.shape == (2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tsrv.served == 1 and len(tsrv.latencies) == 1


def test_serve_batch_tokens_equal_reference_and_solo(yi64):
    jsrv, tsrv = yi64
    want = jsrv.serve_batch(PROMPTS)
    got = tsrv.serve_batch(PROMPTS)
    assert len(got) == 3
    for p, g, w in zip(PROMPTS, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tsrv.serve(p[None])[0])


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_default_reduced_config_matches_reference(arch):
    """The launchers' own reduced configuration (head_dim 16: the plain
    attention path in both packages, the norm kernel woven)."""
    jsrv, tsrv = _servers(arch)
    for g, w in zip(tsrv.serve_batch(PROMPTS), jsrv.serve_batch(PROMPTS)):
        np.testing.assert_array_equal(g, w)


def test_memoised_second_call_hits(yi64):
    _, tsrv = yi64
    tsrv.memo = MemoTable(size=8)
    try:
        prompts = [np.ones((4,), np.int32), np.zeros((6,), np.int32)]
        a = tsrv.serve_batch(prompts)
        served = tsrv.served
        b = tsrv.serve_batch(prompts)
        assert tsrv.memo.hits >= 1 and tsrv.served == served
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        solo = np.full((1, 5), 3, np.int32)
        np.testing.assert_array_equal(tsrv.serve(solo), tsrv.serve(solo))
        assert tsrv.memo.hits >= 2
    finally:
        tsrv.memo = None


def test_broker_and_margot_see_latency(yi64):
    _, tsrv = yi64
    seen = []
    cb = lambda topic, value, ts: seen.append((topic, value))
    tsrv.broker.subscribe("serve/latency/*", cb)
    try:
        tsrv.serve(np.full((1, 4), 9, np.int32))
    finally:
        tsrv.broker.unsubscribe(cb)
    assert seen and seen[0][0] == "serve/latency/@host0" and seen[0][1] > 0


def test_weave_reports_agree(yi64):
    """selects / attributes / actions / inserts per aspect the two default
    weaves share (the reference also weaves its tuner-cache aspect, which the
    port does not have yet)."""
    jsrv, tsrv = yi64
    treport = [dataclasses.astuple(m) for m in tsrv.woven.report.per_aspect]
    names = {m[0] for m in treport}
    jreport = [dataclasses.astuple(m) for m in jsrv.woven.report.per_aspect
               if m.name in names]
    assert treport == jreport
    assert [m[0] for m in treport].count("KernelSubstitution") == 4
    for kind in ("attention", "norm", "rglru", "wkv"):
        assert ("*", kind, "cuda") in tsrv.woven.state.impls
    assert tsrv.woven.state.extra["layout"] == jsrv.woven.state.extra["layout"]


def test_launcher_cli_on_cpu(capsys):
    from repro_torch.launch import serve as launcher

    assert launcher.main(["--device", "cpu", "--requests", "2", "--prompt-len", "6",
                          "--decode-tokens", "3"]) == 0
    assert launcher.main(["--device", "cpu", "--batch-serve", "--requests", "3",
                          "--prompt-len", "6", "--decode-tokens", "3"]) == 0
    assert launcher.main(["--device", "cpu", "--continuous", "--requests", "3",
                          "--prompt-len", "6", "--decode-tokens", "3"]) == 0
    assert launcher.main(["--device", "cpu", "--stream", "--requests", "2",
                          "--prompt-len", "9", "--decode-tokens", "3",
                          "--prefill-chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 2 on cpu" in out and "batched wave: 3 request(s)" in out
    assert "continuous wave: 3 request(s)" in out
    assert " token " in out and out.count(": ok ") == 5
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--device", "cpu", "--fleet", "2"])
    assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
