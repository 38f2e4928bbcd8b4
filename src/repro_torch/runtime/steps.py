"""Step functions: woven program -> train / prefill / decode functions.

This is where the separation of concerns pays off: the functions below read
*only* the WeaveState (policies, impls, rules, extra) — every knob the
ANTAREX aspects set lands here, and libVC keeps one closure per variant.
PyTorch runs eagerly, so there is nothing to compile: a step is a plain
closure.  The serving steps run under `torch.no_grad()`; the train step
records the forward and differentiates it.  The verify step arrives with
its slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.weaver import WovenProgram
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import leaves as tree_leaves
from repro_torch.optim.tree import rebuild


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean token NLL + accuracy. logits (B,T,V) may cover more positions
    than labels (VLM image prefix): align to the last T_label positions."""
    T = labels.shape[1]
    logits = logits[:, -T:].to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.long))[..., 0]
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return torch.mean(nll), acc


def build_loss_fn(woven: WovenProgram, mesh=None, variant: str | None = None):
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model

    def loss_fn(params, batch):
        ctx = state.make_ctx(mesh=mesh)
        logits, _ = model(params, batch, ctx=ctx, mode="dense")
        loss, acc = _cross_entropy(logits, batch["labels"])
        metrics = {"loss": loss, "accuracy": acc}
        metrics.update(ctx.taps)
        return loss, metrics

    return loss_fn


def build_grad_fn(woven: WovenProgram, mesh=None, variant: str | None = None):
    """`jax.value_and_grad(loss_fn, has_aux=True)` for the port:
    grad_fn(params, batch) -> ((loss, metrics), grads), grads a tree shaped
    like params.  It differentiates detached views of the parameters
    (`torch.autograd.grad`): nothing lands in `.grad`, and the parameters
    themselves never require grad."""
    loss_fn = build_loss_fn(woven, mesh, variant)

    def grad_fn(params, batch):
        flat = tree_leaves(params)
        diff = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = loss_fn(rebuild(params, diff), batch)
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), rebuild(params, grads)

    return grad_fn


def build_train_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                     opt_cfg: AdamWConfig | None = None,
                     lr_fn: Callable | None = None):
    """Returns train_step(params, opt_state, batch, step) -> (params, opt, metrics).

    Gradient accumulation (woven knob "accum_steps") loops over microbatches
    in Python, with the woven remat policy applied inside the model's layer
    stacks; gradients accumulate in fp32 sums.  Memory, not arithmetic, is
    where this differs from the reference: each microbatch's gradients are
    added into the fp32 sums and dropped before the next one, and the AdamW
    update then writes the parameters, the master weights and m / v **in
    place** and scales the fp32 sums in place (`optim/adamw.py`).  The
    returned params and opt_state are the tensors that were passed in.
    `batch` holds (B, S) integer tensors on the parameters' device.
    """
    from repro_torch.optim.schedule import warmup_cosine

    state = woven.variant_state(variant)
    opt_cfg = opt_cfg or AdamWConfig(
        compression=bool(state.extra.get("grad_compression", False)),
        state_dtype=str(state.extra.get("opt_state_dtype", "float32")),
    )
    lr_fn = lr_fn or warmup_cosine
    accum = int(state.extra.get("accum_steps", 1))
    grad_fn = build_grad_fn(woven, mesh, variant)

    def train_step(params, opt_state, batch, step):
        if accum > 1:
            b = next(iter(batch.values())).shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} microbatches")
            mbs = b // accum
            gsum, per_micro = None, []
            for i in range(accum):
                mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                (_, metrics), grads = grad_fn(params, mb)
                if gsum is None:
                    gsum = [g.to(torch.float32, copy=True) for g in tree_leaves(grads)]
                else:
                    for acc, g in zip(gsum, tree_leaves(grads)):
                        acc.add_(g)
                del grads
                per_micro.append(metrics)
            grads = rebuild(params, [g.div_(accum) for g in gsum])
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_micro]), dim=0)
                       for k in per_micro[0]}
        else:
            (_, metrics), grads = grad_fn(params, batch)

        lr = lr_fn(step)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, lr)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def build_prefill_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                       cache_max_len: int | None = None):
    """`cache_max_len` pins the prefill cache padding on a *copied* weave
    state, without disturbing the shared state the ordinary prefill reads."""
    program = woven.program
    state = woven.variant_state(variant)
    if cache_max_len is not None:
        state = state.copy()
        state.extra["cache_max_len"] = cache_max_len
    model = program.model

    def prefill_step(params, inputs):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, cache = model(params, inputs, ctx=ctx, mode="prefill")
        return logits, cache

    return prefill_step


def build_paged_prefill_step(woven: WovenProgram, *, mesh=None,
                             variant: str | None = None):
    """Prefill straight into a paged KV pool: `cache` carries the per-layer
    `{"pk", "pv"}` pools (and scale sidecars) + the request's block-table
    row, `prefix_len` is how many leading slots are already resident via
    prefix sharing — the model computes and writes only the non-shared
    suffix, in place, so admission's transient memory is O(live tokens),
    never O(max_len)."""
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model

    def paged_prefill_step(params, inputs, cache, prefix_len: int = 0):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="prefill",
                                      cache=cache, prefix_len=prefix_len)
        return logits, new_cache

    return paged_prefill_step


def build_decode_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                      rescore: bool = False):
    """The decode step **mutates** the cache it is given: the new tokens'
    K/V and positions are written into the cache tensors in place (where the
    reference donates the buffers), and those tensors come back in the
    returned cache.  Every caller rebinds its cache to the step's output.

    `rescore=True` builds the no-write step (paged caches only): a
    full-prompt prefix hit re-scores its last prompt token — whose K/V
    already sit on shared pool pages — for the first output logits, without
    touching pages other requests still map."""
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model
    extra_kw = {"skip_cache_write": True} if rescore else {}

    def decode_step(params, inputs, cache):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="decode",
                                      cache=cache, **extra_kw)
        return logits, new_cache

    return decode_step


def stack_request_caches(model, caches: list) -> Any:
    """Stack per-request (batch=1) prefill caches into one batched decode
    cache with per-request `index` — the *dense* multi-request serving
    layout: every request pads to the same cache length, so device memory
    scales with batch x max_len.  The paged pool (`runtime/pages.py`)
    replaces it in continuous serving; this stays the reference layout the
    paged path must match bit for bit."""
    if len(caches) == 1:
        return caches[0]
    return model.stack_caches(caches)


# ---------------------------------------------------------------------------
# Heuristics shared by the launchers
# ---------------------------------------------------------------------------


def default_accum(cfg, shape_kind: str) -> int:
    """Microbatching that bounds live activations/logits in training; serving
    shapes never accumulate."""
    if shape_kind != "train":
        return 1
    if cfg.family in ("ssm", "hybrid"):
        return 1
    n = cfg.param_count()
    if n >= 200e9:
        return 32
    if n >= 50e9:
        return 16
    return 8


def model_flops_per_token(cfg) -> float:
    """MODEL_FLOPS/token = 6·N_active (the useful compute of a train step)."""
    return 6.0 * cfg.active_param_count()


def step_flops(cfg, shape) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    f = model_flops_per_token(cfg) * tokens
    if shape.kind != "train":
        f /= 3.0  # forward only
    return f
