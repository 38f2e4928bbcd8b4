"""PyTorch port, the training slice against the reference: AdamW (fp32 and
bf16 state, compression on and off), the schedules, int8 error-feedback
compression, the token pipeline, and one whole `build_train_step` step of
reduced yi-6b and gemma-2b at head_dim 64 (so the reference reaches its
Pallas flash attention, forward and fused backward, in interpret mode) —
fp32 policy, 1 and 2 microbatches.  Also the port's own remat (`full`
equals `none`), the launcher on the CPU, and the forward-only kernels'
refusal under autograd.

Tolerances: the optimizer and the schedules in fp32 agree within 1e-6
(same formulas, same order; XLA and PyTorch may fuse a multiply-add
otherwise); a bf16 m / v may round one bf16 step apart where the fp32
values sit near a rounding boundary (3e-3 relative).  The train step holds
the loss and the metrics within 1e-5 and m / v within 1e-4 (two layers of
reordered fp32 sums through attention, the cross-entropy over 512 logits and
the gradient of every parameter), the updated weights within 2e-6 absolute
(0.2 % of the step size; see ADAM_EPS)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import KernelAspect as JKernelAspect
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.weave import default_weave as jweave
from repro.models.registry import build_model as jbuild
from repro.models.registry import reduced_config as jreduced
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro.runtime.steps import build_train_step as jbuild_train_step
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_opt_state, load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import build
from repro_torch.launch import train as launch_train
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn import stack as stack_mod
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import init_params, param_tree
from repro_torch.optim import adamw, compression, schedule
from repro_torch.optim.tree import leaves
from repro_torch.runtime.steps import build_grad_fn, build_train_step

from _torch_port import np_tree, t, to_np

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    return {"w": rng.standard_normal((8, 40)).astype(np.float32),
            "blk": {"a": rng.standard_normal((3, 50)).astype(np.float32),
                    "norm": rng.standard_normal((16,)).astype(np.float32)}}


def _assert_close_tree(ours, theirs, rtol, atol, path=""):
    if isinstance(theirs, dict):
        for k in theirs:
            _assert_close_tree(ours[k], theirs[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs, np.float32), rtol=rtol,
                               atol=atol, err_msg=path)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_the_reference_over_three_steps(state_dtype, compress):
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    jcfg = jadamw.AdamWConfig(state_dtype=state_dtype, compression=compress)
    tcfg = adamw.AdamWConfig(state_dtype=state_dtype, compression=compress)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init_state(jp, jcfg)
    tp = {"w": t(params["w"]), "blk": {k: t(v) for k, v in params["blk"].items()}}
    tstate = adamw.init_state(tp, tcfg)
    # the state is rounded to bf16 at every step: one rounding that falls
    # the other way moves m or v by one bf16 step (2^-8 relative)
    tol = dict(rtol=1e-6, atol=1e-6) if state_dtype == "float32" else \
        dict(rtol=3e-3, atol=1e-6)
    for step in range(3):
        grads = jax.tree.map(lambda x: (10.0 ** (step - 1) * rng.standard_normal(x.shape))
                             .astype(np.float32), params)
        lr_j = jsched.warmup_cosine(step + 20, warmup=10, total=100)
        lr_t = schedule.warmup_cosine(step + 20, warmup=10, total=100)
        jp, jstate, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, grads), jstate,
                                              jcfg, lr_j)
        tgrads = jax.tree.map(lambda x: t(x), grads)
        tp, tstate, tm = adamw.apply_updates(tp, tgrads, tstate, tcfg, lr_t)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        _assert_close_tree(tp, np_tree(jp), **tol)
        for key in ("master", "m", "v") + (("ef",) if compress else ()):
            _assert_close_tree(tstate[key], np_tree(jstate[key]), **tol, path=key)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        for key in ("m", "v"):
            assert all(x.dtype == adamw._state_dtype(tcfg) for x in leaves(tstate[key]))


@pytest.mark.parametrize("fn", ["warmup_cosine", "constant"])
def test_schedules_match_the_reference(fn):
    steps = [0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000]
    got = [float(getattr(schedule, fn)(s)) for s in steps]
    want = [float(getattr(jsched, fn)(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_error_feedback_compression_matches_the_reference():
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    ef = (rng.standard_normal((6, 300)) * 0.01).astype(np.float32)
    q, s = compression.quantize_int8(t(g))
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    deq, new_ef = compression.ef_compress(t(g), t(ef))
    jdeq, jef = jcomp.ef_compress(jnp.asarray(g), jnp.asarray(ef))
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new_ef.numpy(), np.asarray(jef), rtol=1e-5, atol=1e-7)
    small = t(g[0, :100])  # under 128 elements: passed through
    assert compression.ef_compress(small, small)[0] is small
    tree = {"a": t(g), "b": t(np.zeros(5, np.float32))}
    assert compression.compressed_bytes(tree) == jcomp.compressed_bytes(
        {"a": jnp.asarray(g), "b": jnp.zeros(5)})


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lcg", "uniform", "memmap"])
def test_pipeline_batches_equal_the_reference_bit_for_bit(mode, tmp_path):
    path = None
    if mode == "memmap":
        path = str(tmp_path / "corpus.bin")
        np.random.default_rng(2).integers(0, 10_000, 5000).astype(np.int32).tofile(path)
    kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=3, mode=mode, memmap_path=path)
    for host in (0, 1):
        ours = TokenPipeline(PipelineConfig(**kw), host_id=host, num_hosts=2)
        theirs = JTokenPipeline(JPipelineConfig(**kw), host_id=host, num_hosts=2)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype and a[k].shape == (4, 24)
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state_dict() == theirs.state_dict()


# ---------------------------------------------------------------------------
# one train step against the reference
# ---------------------------------------------------------------------------

# Adam's step m / (sqrt(v) + eps) is lr x sign(g) for most elements, but
# where |g| is near eps it follows the gradient's last bits, which two fp32
# summation orders set otherwise (at the default eps 1e-8, single elements
# part by 4 % of lr).  Both sides take eps 1e-6 here: the step then depends
# on gradients the summation order cannot move by more than 1e-6 of it.
ADAM_EPS = 1e-6
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32}


def _woven_pair(arch, accum):
    jcfg = jreduced(arch).replace(head_dim=64)
    tcfg = reduced_config(arch).replace(head_dim=64)
    overrides = {"accum_steps": accum, "remat": "full", "tuned_kernels": False, **EXTRA}
    jw = jweave(JProgram(model=jbuild(jcfg), cfg=jcfg, kind="train"), JSHAPES["train_4k"],
                {}, overrides=dict(overrides),
                extra_aspects=[JKernelAspect("*", "attention", "pallas")])
    tw = default_weave(Program(model=build_model(tcfg), cfg=tcfg, kind="train"),
                       SHAPES["train_4k"], {}, overrides=dict(overrides),
                       extra_aspects=[KernelAspect("*", "attention", "cuda")])
    # fp32 everywhere (`ChangePrecision` retypes the modules it selects and
    # leaves e.g. the final norm's output at the base policy's bf16)
    jw.state.policies = JPolicies.default("f32")
    tw.state.policies = TPolicies.default("f32")
    return jw, tw


@functools.lru_cache(maxsize=None)
def _jitted_step(arch, accum):
    jw, _ = _woven_pair(arch, accum)
    lr = functools.partial(jsched.constant, peak=1e-3)
    return jw, jax.jit(jbuild_train_step(jw, lr_fn=lr,
                                         opt_cfg=jadamw.AdamWConfig(eps=ADAM_EPS)))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_train_step_matches_the_reference(arch, accum, monkeypatch):
    jw, jstep = _jitted_step(arch, accum)
    _, tw = _woven_pair(arch, accum)
    jparams = jinit(jw.program.model, jax.random.PRNGKey(0), jw.state.policies)
    jopt = jadamw.init_state(jparams, jadamw.AdamWConfig())
    tmodel = tw.program.model
    init_params(tmodel, 0, tw.state.policies, "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    assert all(p.dtype == torch.float32 for p in leaves(tparams))
    topt = adamw.init_state(tparams, adamw.AdamWConfig())
    tstep = build_train_step(tw, lr_fn=functools.partial(schedule.constant, peak=1e-3),
                             opt_cfg=adamw.AdamWConfig(eps=ADAM_EPS))

    # the port's attention runs its fused backward, never autograd through
    # the plain attention
    from repro_torch.kernels.flash_attention import ops
    calls = []
    real = ops.flash_attention_bwd_ref
    monkeypatch.setattr(ops, "flash_attention_bwd_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    pipe = JTokenPipeline(JPipelineConfig(vocab=512, seq_len=16, global_batch=4))
    for step in range(2):
        batch = next(pipe)
        jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batch),
                                  jnp.asarray(step, jnp.int32))
        tparams, topt, tm = tstep(tparams, topt, {k: t(v) for k, v in batch.items()}, step)
        for k in ("loss", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for tree, want in ((tparams, jparams), (topt["master"], jopt["master"])):
            _assert_close_tree(tree, np_tree(want), rtol=1e-4, atol=2e-6)
        for key in ("m", "v"):
            _assert_close_tree(topt[key], np_tree(jopt[key]), rtol=1e-4, atol=1e-6,
                               path=key)
        if step == 0:
            # the optimizer state crosses over from the reference: continue
            # the port's run from the reference's own state
            topt = load_jax_opt_state(tmodel, np_tree(jopt))
            load_jax_params(tmodel, np_tree(jparams))
    assert int(topt["count"]) == int(jopt["count"]) == 2
    layers = tw.program.cfg.num_layers
    assert len(calls) == 2 * accum * layers


def test_remat_full_gives_the_gradients_of_remat_none(monkeypatch):
    cfg = reduced_config("gemma-2b").replace(head_dim=64)
    model = build_model(cfg)
    init_params(model, 0, None, "cpu")
    params = param_tree(model)
    batch = {k: t(v) for k, v in TokenPipeline(PipelineConfig(
        vocab=512, seq_len=16, global_batch=2)).batch_at(0).items()}
    checkpointed = []
    real = stack_mod.checkpoint
    monkeypatch.setattr(stack_mod, "checkpoint",
                        lambda *a, **k: checkpointed.append(1) or real(*a, **k))

    def grads(remat):
        w = default_weave(Program(model=model, cfg=cfg, kind="train"), SHAPES["train_4k"],
                          {}, overrides={"remat": remat, "accum_steps": 1},
                          extra_aspects=[KernelAspect("*", "attention", "cuda")])
        (loss, _), g = build_grad_fn(w)(params, batch)
        return loss, leaves(g)

    loss_full, g_full = grads("full")
    assert len(checkpointed) == cfg.num_layers
    loss_none, g_none = grads("none")
    assert len(checkpointed) == cfg.num_layers  # "none" checkpoints nothing
    assert torch.equal(loss_full, loss_none)
    for a, b in zip(g_full, g_none):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="later training slice"):
        grads("dots")


def test_launcher_trains_the_reduced_config_on_the_cpu(capsys):
    assert launch_train.main(["--device", "cpu", "--reduced", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "over 3 steps on cpu" in out


def test_launcher_refuses_recurrent_training_on_the_card():
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        with pytest.raises(NotImplementedError, match="later slice"):
            launch_train.build_trainer(arch, reduced=True, device="cuda", batch=2, seq=8)


def test_forward_only_kernels_refuse_autograd():
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rwkv6.ops import wkv

    x = torch.randn(3, 16)
    w = torch.ones(16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        rmsnorm(x, w)
    with pytest.raises(RuntimeError, match="forward-only"):
        build.refuse_grad("k", x.requires_grad_(True))
    a = torch.rand(1, 5, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        rglru(a, a.detach(), torch.zeros(1, 8))
    r = torch.randn(1, 5, 2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        wkv(r, r.detach(), r.detach(), torch.rand(1, 5, 2, 4), torch.zeros(2, 4),
            torch.zeros(1, 2, 4, 4))
    with torch.no_grad():  # the serving path: no gradient asked, no refusal
        assert rmsnorm(x, w).shape == (3, 16)
        assert rglru(a, a, torch.zeros(1, 8))[0].shape == (1, 5, 8)
    build.refuse_grad("k", x.detach(), 3.0)  # nothing that needs a gradient


def test_trainer_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.build_trainer("gemma-2b", reduced=True, device="cuda", batch=2, seq=8)
