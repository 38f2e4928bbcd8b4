"""PyTorch port, training the hybrid, ssm and MoE families and the remat
policies, against the reference, on the CPU.

- One `build_train_step` step of reduced recurrentgemma-2b (hybrid: the
  unrolled blocks, each checkpointed whole), rwkv6-3b (ssm), mixtral-8x22b
  (MoE, sliding window) and grok-1-314b (MoE, soft-cap) against the
  reference's jitted step, on the reference's weights carried across
  (`convert.load_jax_params`) and one numpy batch from a seed: fp32
  policy, head_dim 64 with the attention kernels woven (the reference's
  Pallas forward and fused backward in interpret mode; the port's kernel
  wrappers, which take their plain versions for CPU tensors), remat
  `full`.  Loss, grad norm and every updated parameter within 1e-4: fp32
  everywhere, the sums reordered (the counterpart of the reference's
  `tests/test_models_smoke.py::test_train_step_no_nans`).
- The remat policies `none` / `full` / `dots` / `dots_no_batch` on reduced
  yi-6b (a layer stack) and recurrentgemma-2b (unrolled blocks): the same
  loss and gradients bit for bit, and the backward recomputes exactly the
  matrix products each policy leaves unsaved, counted by a
  `TorchDispatchMode` — every product of the layers under `full` but each
  block's last (its output is never read), none under `dots`, the batched
  ones (`bmm`: attention, the RG-LRU's block diagonal) under
  `dots_no_batch`; the hybrid checkpoints each block whole, saving
  nothing, under every policy but `none`, as the reference does, so each
  block runs twice."""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import SHAPES as JSHAPES
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import KernelAspect as JKernelAspect
from repro.launch.weave import default_weave as jweave
from repro.models.registry import build_model as jbuild
from repro.models.registry import reduced_config as jreduced
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.runtime.steps import build_train_step as jbuild_train_step
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch.weave import default_weave
from repro_torch.models import lm as lm_mod
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import init_params, param_tree
from repro_torch.optim import adamw, schedule
from repro_torch.optim.tree import leaves, rebuild
from repro_torch.runtime.steps import build_loss_fn, build_train_step

from _torch_port import np_tree, t, to_np

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 everywhere; reordered sums only
ADAM_EPS = 1e-6  # keeps the first step's update off the sign of a vanishing gradient
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "tuned_kernels": False}
B, S = 2, 32  # past the reduced windows (16): the window prunes


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, S)).astype(np.int32)}


def _woven_pair(arch):
    jcfg = jreduced(arch).replace(head_dim=64)
    tcfg = reduced_config(arch).replace(head_dim=64)
    over = {"accum_steps": 1, "remat": "full", **EXTRA}
    jw = jweave(JProgram(model=jbuild(jcfg), cfg=jcfg, kind="train"), JSHAPES["train_4k"],
                {}, overrides=dict(over),
                extra_aspects=[JKernelAspect("*", "attention", "pallas")])
    tw = default_weave(Program(model=build_model(tcfg), cfg=tcfg, kind="train",
                               device="cpu"),
                       SHAPES["train_4k"], {}, overrides=dict(over),
                       extra_aspects=[KernelAspect("*", "attention", "cuda")])
    jw.state.policies = JPolicies.default("f32")
    tw.state.policies = TPolicies.default("f32")
    return jw, tw


def _close_tree(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _close_tree(ours[k], theirs[k], f"{path}/{k}")
        return
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs, np.float32), err_msg=path,
                               **TOL)


@pytest.mark.parametrize("arch,attn_layers", [
    ("recurrentgemma-2b", 1), ("rwkv6-3b", 0), ("mixtral-8x22b", 2), ("grok-1-314b", 2)])
def test_train_step_matches_the_reference(arch, attn_layers, monkeypatch):
    jw, tw = _woven_pair(arch)
    jparams = jinit(jw.program.model, jax.random.PRNGKey(0), jw.state.policies)
    jopt = jadamw.init_state(jparams, jadamw.AdamWConfig())
    tmodel = tw.program.model
    init_params(tmodel, 0, tw.state.policies, "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    assert all(p.dtype == torch.float32 for p in leaves(tparams))
    before = np_tree(jparams)
    topt = adamw.init_state(tparams, adamw.AdamWConfig())
    opt_cfg = dict(eps=ADAM_EPS)
    jstep = jax.jit(jbuild_train_step(jw, lr_fn=functools.partial(jsched.constant, peak=1e-3),
                                      opt_cfg=jadamw.AdamWConfig(**opt_cfg)))
    tstep = build_train_step(tw, lr_fn=functools.partial(schedule.constant, peak=1e-3),
                             opt_cfg=adamw.AdamWConfig(**opt_cfg))
    # the attention's gradient is the fused backward's plain version, once a
    # layer: never autograd through the plain attention
    calls = []
    real = attn_ops.flash_attention_bwd_ref
    monkeypatch.setattr(attn_ops, "flash_attention_bwd_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = _batch()
    jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batch),
                              jnp.asarray(0, jnp.int32))
    tparams, topt, tm = tstep(tparams, topt, {k: t(v) for k, v in batch.items()}, 0)
    assert len(calls) == attn_layers
    for k in ("loss", "accuracy", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
    assert np.isfinite(float(tm["loss"])) and float(tm["grad_norm"]) > 0
    _close_tree(tparams, np_tree(jparams))
    _close_tree(topt["master"], np_tree(jopt["master"]), "master")
    # every parameter moved, in both packages alike
    moved = [np.abs(to_np(a) - b).max() for a, b in zip(leaves(tparams), leaves(before))]
    assert min(moved) > 0


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

_PRODUCTS = {torch.ops.aten.mm: "mm", torch.ops.aten.addmm: "mm",
             torch.ops.aten.bmm: "bmm", torch.ops.aten.baddbmm: "bmm"}


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched while active: `mm` (no batch
    dimension) and `bmm` (batched)."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = _PRODUCTS.get(func.overloadpacket)
        if kind:
            self.n[kind] += 1
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _remat_model(arch):
    cfg = reduced_config(arch).replace(head_dim=64)
    model = build_model(cfg)
    init_params(model, 0, None, "cpu")
    return cfg, model, param_tree(model)


def _grads(arch, remat, skip_trunk=False):
    """Loss and gradients under `remat`, with the products dispatched by
    the forward and by the backward counted apart."""
    cfg, model, params = _remat_model(arch)
    woven = default_weave(Program(model=model, cfg=cfg, kind="train", device="cpu"),
                          SHAPES["train_4k"],
                          {}, overrides={"remat": remat, "accum_steps": 1, **EXTRA},
                          extra_aspects=[KernelAspect("*", "attention", "cuda")])
    if skip_trunk:
        woven.state.extra["skip_trunk"] = True
    batch = {k: t(v) for k, v in _batch(7).items()}
    flat = leaves(params)
    diff = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        with _Products() as fwd:
            loss, _ = build_loss_fn(woven)(rebuild(params, diff), batch)
        with _Products() as bwd:
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
    return loss.detach(), grads, fwd.n, bwd.n


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-2b"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    blocks = Counter()
    for cls in (lm_mod.DecoderBlock, lm_mod.RecBlock):
        real = cls.forward

        def counted(self, *a, _real=real, **k):
            blocks[self.name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(cls, "forward", counted)

    cfg, _, _ = _remat_model(arch)
    loss0, g0, fwd0, bwd0 = _grads(arch, "none")
    runs0 = sum(blocks.values())
    _, _, outside, _ = _grads(arch, "none", skip_trunk=True)
    layers = {k: fwd0[k] - outside[k] for k in ("mm", "bmm")}  # the trunk's products
    assert layers["mm"] > 0 and layers["bmm"] > 0
    hybrid = cfg.family == "hybrid"
    assert runs0 == cfg.num_layers  # one forward of each layer or block
    for remat in ("full", "dots", "dots_no_batch"):
        blocks.clear()
        loss, g, fwd, bwd = _grads(arch, remat)
        assert fwd == fwd0, remat  # the forward is the same under every policy
        assert torch.equal(loss, loss0), remat
        for a, b in zip(g, g0):
            assert (a is None and b is None) or torch.equal(a, b), remat
        recomputed = {k: bwd[k] - bwd0[k] for k in ("mm", "bmm")}
        if hybrid or remat == "full":
            # nothing saved: every block reruns, with every product of the
            # trunk but each block's last, the MLP's down projection — its
            # output only joins the residual, and the recompute stops after
            # the last tensor the backward reads (JAX's dead-code
            # elimination drops it alike)
            want = {"mm": layers["mm"] - cfg.num_layers, "bmm": layers["bmm"]}
            assert sum(blocks.values()) == 2 * cfg.num_layers, remat
            if hybrid:
                assert set(blocks) == {f"layer{i:02d}" for i in range(cfg.num_layers)}
        elif remat == "dots":
            want = {"mm": 0, "bmm": 0}  # every product saved
        else:
            want = {"mm": 0, "bmm": layers["bmm"]}  # the batched products rerun
        assert recomputed == want, (remat, recomputed, want)
