"""Step functions: woven program -> train / prefill / decode functions.

This is where the separation of concerns pays off: the functions below read
*only* the WeaveState (policies, impls, rules, extra) — every knob the
ANTAREX aspects set lands here, and libVC keeps one closure per variant.
PyTorch runs eagerly, so there is nothing to compile: a step is a plain
closure.  The serving steps run under `torch.no_grad()`; the train step
records the forward and differentiates it.

`mesh` is None, a mesh of one device (`launch/mesh.make_card_mesh`: the
same kernels, launches and bits as None) or a live mesh of several ranks
(`launch/mesh.make_mesh`) under one of AutoShard's layouts.  There every
rank runs the step on its blocks: the parameters are its local shards (an
FSDP block is gathered where the model uses it), the serving steps take the
rows the caller hands them — the whole batch under Megatron's layout (the
page pool is shared by every request, so `data` replicates a server), the
rank's rows under `dp_fsdp` (`runtime/server.py` splits them) — and hand
back the logits gathered over the vocab, and the train step takes the
global batch, keeps its rows (`sharding.input_shardings`), and sums the
gradients over the axes whose ranks hold other tokens and means them over
the batch's (`sharding.grad_axes`).  The dense, MoE, encoder-decoder and
VLM families run under `megatron_tp` and `fsdp_sp` (serving under
`fsdp_sp` holds each rank's share of every KV cache and page pool and keeps
the batch replicated over `data`, as Megatron's does); the ssm and hybrid
families run under `dp_fsdp`.  The layouts a family is not laid out in
raise when the step is built.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.weaver import WovenProgram
from repro_torch.distributed.collectives import all_reduce, reduce_from
from repro_torch.distributed.sharding import seq_axis
from repro_torch.launch.mesh import check_mesh, is_live
from repro_torch.models.lm import greedy_argmax, vocab_cross_entropy, whole_logits
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import leaves as tree_leaves
from repro_torch.optim.tree import rebuild


# the layouts each family runs under on a live mesh: AutoShard's own choices
_ATTENTION_LAYOUTS = ("megatron_tp", "fsdp_sp")
MESH_LAYOUTS = {"dense": _ATTENTION_LAYOUTS, "moe": _ATTENTION_LAYOUTS,
                "encdec": _ATTENTION_LAYOUTS, "vlm": _ATTENTION_LAYOUTS,
                "ssm": ("dp_fsdp",), "hybrid": ("dp_fsdp",)}


def check_on_mesh(woven: WovenProgram, mesh, state=None):
    """`mesh` if a step of `woven` runs on it (`launch/mesh.check_mesh`); a
    live mesh of several ranks takes the dense, MoE, encoder-decoder and
    VLM families under `megatron_tp` and `fsdp_sp` and the ssm and hybrid
    families under `dp_fsdp` (`MESH_LAYOUTS`, `sharding.check_layout`)."""
    mesh = check_mesh(mesh)
    if not is_live(mesh):
        return mesh
    from repro_torch.distributed.sharding import check_layout

    family = woven.program.cfg.family
    state = state or woven.state
    layout = state.extra.get("layout") or "megatron_tp"
    if layout not in MESH_LAYOUTS[family]:
        raise NotImplementedError(
            f"the {family} family ({woven.program.cfg.name}) under {layout} on a live "
            f"mesh: it runs under {' or '.join(MESH_LAYOUTS[family])}, the layouts "
            f"AutoShard picks for it (no layout of AutoShard lays it out so)")
    check_layout(mesh, state.rules, layout)
    return mesh


def _block_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mesh, sp: str):
    """`fsdp_sp` with a vocab the sequence axis does not divide: `logits`
    (B, s, vocab) are this rank's block of the P + T positions, positions
    [c·s, (c+1)·s); the labels cover the last T of them (P: a VLM's image
    prefix).  The rank's NLL and hits are sums over its labelled
    positions, divided by the global count of labels (B·T) and added over
    `sp`: the loss is the mean on every rank, and its gradient there the
    rank's share, which the train step's sum over `sp` completes."""
    B, T = labels.shape
    s = logits.shape[1]
    start = mesh.coord(sp) * s
    prefix = s * mesh.shape[sp] - T
    first = min(max(prefix - start, 0), s)  # the block's first labelled position
    lo = start + first - prefix
    mine = logits[:, first:].to(torch.float32)
    lab = labels[:, lo:lo + s - first].to(torch.long)
    logp = F.log_softmax(mine, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    hits = torch.sum((torch.argmax(mine.detach(), dim=-1) == lab).to(torch.float32))
    count = float(B * T)
    return (reduce_from(torch.sum(nll) / count, mesh, sp),
            all_reduce(hits / count, mesh, sp))


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mesh=None,
                   vocab: int | None = None, sp: str | None = None):
    """Mean token NLL + accuracy. logits (B,T,V) may cover more positions
    than labels (VLM image prefix): align to the last T_label positions.
    On a live mesh the logits may be a rank's vocab block (V = vocab / tp),
    or under `fsdp_sp` (`sp`) a rank's block of positions over the whole
    vocab (`_block_cross_entropy`)."""
    if sp is not None and logits.shape[-1] == vocab:
        return _block_cross_entropy(logits, labels, mesh, sp)
    T = labels.shape[1]
    logits = logits[:, -T:].to(torch.float32)
    if vocab is not None and logits.shape[-1] != vocab:
        nll = vocab_cross_entropy(logits, labels, mesh)
        top = greedy_argmax(logits.detach(), mesh, vocab)
        return torch.mean(nll), torch.mean((top == labels).to(torch.float32))
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.long))[..., 0]
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return torch.mean(nll), acc


def build_loss_fn(woven: WovenProgram, mesh=None, variant: str | None = None):
    """loss_fn(params, batch) -> (loss, metrics); on a live mesh `batch`
    holds this rank's rows and the loss is their mean."""
    check_on_mesh(woven, mesh, woven.variant_state(variant))
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model
    sp = seq_axis(mesh, state.rules)

    def loss_fn(params, batch):
        ctx = state.make_ctx(mesh=mesh)
        logits, _ = model(params, batch, ctx=ctx, mode="dense")
        loss, acc = _cross_entropy(logits, batch["labels"], mesh, program.cfg.vocab, sp)
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

    On a live mesh `params` and `opt_state` are this rank's shards and
    `batch` the global batch: the step keeps its rows
    (`sharding.input_shardings`), sums each leaf's gradient over the axes
    whose ranks hold other tokens (`sharding.grad_axes`) but not over the
    axes the leaf is split on — an FSDP block's gather already summed its
    gradient over them, a Megatron or vocab block's is its own — and
    divides by the batch axes' extent; the metrics are meaned over the
    batch axes; the clipping norm sums each leaf's squares over the axes it
    is split on (`adamw.global_norm`).
    """
    from repro_torch.optim.schedule import warmup_cosine

    state = woven.variant_state(variant)
    mesh = check_on_mesh(woven, mesh, state)
    opt_cfg = opt_cfg or AdamWConfig(
        compression=bool(state.extra.get("grad_compression", False)),
        state_dtype=str(state.extra.get("opt_state_dtype", "float32")),
    )
    split = rows = None  # each leaf: the mesh axes it / its last dim is split over
    if is_live(mesh):
        from repro_torch.distributed.sharding import (input_shardings, local_shard,
                                                      param_shardings)

        split, mesh_mean = build_mesh_mean(woven, mesh, variant)
        rows = [sh.dim_axes(-1) for sh in tree_leaves(
            param_shardings(woven.program.model, mesh, state.rules))]
    lr_fn = lr_fn or warmup_cosine
    accum = int(state.extra.get("accum_steps", 1))
    grad_fn = build_grad_fn(woven, mesh, variant)

    def train_step(params, opt_state, batch, step):
        if split is not None:  # this rank's rows
            shard = input_shardings(batch, mesh, state.rules)
            batch = {k: local_shard(v, shard[k]) for k, v in batch.items()}
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
        if split is not None:
            grads, metrics = mesh_mean(grads, metrics)

        lr = lr_fn(step)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, lr, mesh=mesh, split=split, rows=rows)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def build_mesh_mean(woven: WovenProgram, mesh, variant: str | None = None):
    """(split, mean) for a live mesh: `split[i]` holds the mesh axes leaf i
    of the param tree is split over, and `mean(grads, metrics)` turns this
    rank's gradients and metrics into the global batch's means: each leaf's
    gradient summed over the axes whose ranks hold other tokens
    (`sharding.grad_axes`) less the axes it is split over — an FSDP
    block's gather summed it over those already, a Megatron or vocab
    block's is its own — and divided by the batch axes' extent (in place:
    the gradients are the caller's own tensors); the metrics meaned over
    the batch axes."""
    from repro_torch.distributed.sharding import grad_axes, live_axes, param_shardings

    state = woven.variant_state(variant)
    split = [sh.axes() for sh in tree_leaves(
        param_shardings(woven.program.model, mesh, state.rules))]
    tokens, n_batch = grad_axes(mesh, state.rules)
    batch_axes = live_axes(mesh, state.rules.get("batch"))

    def mean(grads, metrics):
        grads = rebuild(grads, [
            _sum_over(g, mesh, [a for a in tokens if a not in axes]).div_(n_batch)
            for g, axes in zip(tree_leaves(grads), split)])
        metrics = {k: _sum_over(v, mesh, batch_axes) / n_batch for k, v in metrics.items()}
        return grads, metrics

    return split, mean


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`x` summed over the ranks of each of `axes` (`x` itself for none)."""
    for a in axes:
        x = all_reduce(x, mesh, a)
    return x


def build_prefill_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                       cache_max_len: int | None = None):
    """`cache_max_len` pins the prefill cache padding on a *copied* weave
    state, without disturbing the shared state the ordinary prefill reads."""
    program = woven.program
    state = woven.variant_state(variant)
    check_on_mesh(woven, mesh, state)
    if cache_max_len is not None:
        state = state.copy()
        state.extra["cache_max_len"] = cache_max_len
    model = program.model

    def prefill_step(params, inputs):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, cache = model(params, inputs, ctx=ctx, mode="prefill")
        return whole_logits(logits, mesh, program.cfg.vocab), cache

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
    check_on_mesh(woven, mesh, state)
    model = program.model

    def paged_prefill_step(params, inputs, cache, prefix_len: int = 0):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="prefill",
                                      cache=cache, prefix_len=prefix_len)
        return whole_logits(logits, mesh, program.cfg.vocab), new_cache

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
    check_on_mesh(woven, mesh, state)
    model = program.model
    extra_kw = {"skip_cache_write": True} if rescore else {}

    def decode_step(params, inputs, cache):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="decode",
                                      cache=cache, **extra_kw)
        return whole_logits(logits, mesh, program.cfg.vocab), new_cache

    return decode_step


def build_verify_step(woven: WovenProgram, *, mesh=None,
                      variant: str | None = None,
                      draft_len: int | None = None):
    """Speculative-decoding verify step: one decode-mode call whose inputs
    carry a whole draft block (S = draft_len + 1 tokens per request).  The
    model's decode path returns logits for *all* S positions — row i is
    scored with draft token i attending through cache slot index + i via
    the widened-q `flash_decode` mode — so the host can accept the longest
    prefix where the target's argmax chain reproduces the draft.

    Structurally this is build_decode_step at S > 1 (and, like it, writes
    the block into the cache in place); this function exists so the server
    can pin the draft span on a *copied* weave state (the
    "speculative_draft_len" extra) without disturbing the plain decode
    variant's state.  On a live mesh each rank scores its KV heads and the
    logits come back whole, as the decode step's do."""
    program = woven.program
    state = woven.variant_state(variant)
    check_on_mesh(woven, mesh, state)
    if draft_len is not None:
        state = state.copy()
        state.extra["speculative_draft_len"] = int(draft_len)
    model = program.model

    def verify_step(params, inputs, cache):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="decode",
                                      cache=cache)
        return whole_logits(logits, mesh, program.cfg.vocab), new_cache

    return verify_step


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
