"""Compositional roofline costing on the meta device.

A step is costed as the sum of its *components*, each run once at its true
shape on meta tensors (`analysis.count_costs`: nothing is allocated and no
kernel runs) and multiplied by how often the step runs it:

  train step  = accum x [ sum_b count_b x block_fwdbwd_b  +  outer_fwdbwd ]
                + optimizer_update
                + accum x sum_b count_b x analytic_core_b        (attention / WKV)
  prefill     = sum_b count_b x block_fwd_b + outer_fwd + analytic cores
  decode      = sum_b count_b x block_decode_b + outer_fwd(1 tok)   (no analytic:
                decode attention runs as traced and is counted exactly)

The dense modes weave `proj_only` for attention and WKV, which keeps their
projections and skips the S x T core; the analytic cores (`_causal_context`,
`attention_core_global`, `wkv_core_global`, the reference's arithmetic)
count what the kernels K1 / K3 / K6 do there, from first principles.  No
kernel aspect is woven: `default_weave` weaves none, and a kernel cannot run
on meta tensors anyway.

Remat: a training block runs under the woven remat policy through
`nn/stack.remat_call`, so the traced backward *contains* the recompute
(under `full`, one more forward).  The reference multiplies its block
costs by 8/6 because XLA removes the recompute from a loop-free lowering;
here that factor would count the recompute twice, and it is not applied.
The analytic cores, which no trace holds, are scaled to the remat woven
instead: one rerun of the kernel under any policy but `none`.
The hybrid's unrolled blocks are checkpointed whole under any policy but
`none`, as its model does, once per block.

Only a mesh of one device can be costed: costing a partitioned program
needs an SPMD partitioner, which PyTorch on one card lacks.  On a mesh of
one there are no collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh, make_card_mesh, mesh_name
from repro_torch.nn.module import abstract_params
from repro_torch.nn.stack import remat_call
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.roofline.analysis import count_costs, meta
from repro_torch.roofline.hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# why a mesh of more than one device has no composed roofline
PARTITIONER_REASON = ("costing a partitioned program needs an SPMD partitioner, "
                      "which PyTorch on one card lacks")


@dataclasses.dataclass
class ComponentCost:
    name: str
    count: float  # executions per step
    flops: float  # per execution, per device
    bytes: float
    coll_bytes: float
    coll_ops: dict[str, int] = dataclasses.field(default_factory=dict)

    def total(self) -> tuple[float, float, float]:
        return self.count * self.flops, self.count * self.bytes, self.count * self.coll_bytes

    def to_json(self):
        return {
            "name": self.name, "count": self.count, "flops": self.flops,
            "bytes": self.bytes, "coll_bytes": self.coll_bytes,
            "coll_ops": self.coll_ops,
        }


def _grads(loss: torch.Tensor, inputs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients of `loss` that exist (an unused input has none)."""
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [g for g in grads if g is not None]


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------


def block_component(block, mesh: Mesh, woven, *, B: int, S: int, d_model: int,
                    mode: str, train: bool, remat: str = "none", cache_spec=None,
                    kwargs_spec=None) -> tuple[float, float, float, dict]:
    """(flops, bytes, collective bytes, collective ops) of one block."""
    state = woven.state
    # attention / wkv cores are costed analytically in dense modes
    impls = list(state.impls)
    if mode != "decode":
        impls += [("*", "attention", "proj_only"), ("*", "wkv", "proj_only")]

    def make_ctx():
        ctx = state.make_ctx(mesh=mesh)
        ctx.impls = impls
        return ctx

    params = abstract_params(block, state.policies)
    x = meta(((B, S, d_model), torch.bfloat16))
    positions = meta(((B, S), torch.int32))
    kw = meta(kwargs_spec or {})

    if mode == "decode":
        if cache_spec is None:
            raise ValueError("a decode block needs its cache spec")

        def fn(params, x, positions, cache, kw):
            with torch.no_grad():
                return block(params, x, ctx=make_ctx(), mode="decode", cache=cache,
                             positions=positions, **kw)

        f, b = count_costs(fn, params, x, positions, meta(cache_spec), kw)
    elif train:
        def fn(params, x, positions, kw):
            ctx = make_ctx()
            p, h = _requiring_grad(params), x.detach().requires_grad_(True)

            def fwd(p, h):
                return block(p, h, ctx=ctx, mode="dense", positions=positions, **kw)[0]

            with torch.enable_grad():
                out = fwd(p, h) if remat == "none" else remat_call(
                    fwd, p, h, policy=remat, ctx=ctx)
                return _grads(out.to(torch.float32).sum(), leaves(p) + [h])

        f, b = count_costs(fn, params, x, positions, kw)
    else:  # prefill fwd
        def fn(params, x, positions, kw):
            with torch.no_grad():
                return block(params, x, ctx=make_ctx(), mode="prefill",
                             positions=positions, **kw)

        f, b = count_costs(fn, params, x, positions, kw)
    return f, b, 0.0, {}


def outer_component(woven, mesh: Mesh, specs, *, train: bool, mode: str) -> tuple:
    """Embed + final norm + head + loss, trunk skipped (`skip_trunk`)."""
    state = woven.state
    model = woven.program.model

    def make_ctx():
        ctx = state.make_ctx(mesh=mesh)
        ctx.extra = dict(ctx.extra, skip_trunk=True)
        return ctx

    params = abstract_params(model, state.policies)
    inputs = meta(specs["inputs"])
    if train:
        from repro_torch.runtime.steps import _cross_entropy

        def fn(params, batch):
            p = _requiring_grad(params)
            with torch.enable_grad():
                logits, _ = model(p, batch, ctx=make_ctx(), mode="dense")
                loss, _ = _cross_entropy(logits, batch["labels"])
                return _grads(loss, leaves(p))
    else:
        def fn(params, batch):
            with torch.no_grad():
                return model(params, batch, ctx=make_ctx(), mode=mode)[0]

    f, b = count_costs(fn, params, inputs)
    return f, b, 0.0, {}


def optimizer_component(woven, mesh: Mesh) -> tuple:
    """The AdamW update (`optim/adamw.apply_updates`) over the whole param
    tree: it reads the fp32 gradient sums, the master weights and m / v,
    and writes the parameters (overwritten from the master weights, never
    read), the master weights and m / v back.  The
    gradient sums are the train step's own fp32 temporaries, which the
    update may scale in place; they are handed over as fresh copies, so they
    count as read once and never as written.  The update works in slices
    (`adamw.UPDATE_SLICE`); the count is the same whatever the slice."""
    state = woven.state
    model = woven.program.model
    opt_cfg = AdamWConfig(
        compression=bool(state.extra.get("grad_compression", False)),
        state_dtype=str(state.extra.get("opt_state_dtype", "float32")),
    )
    params = abstract_params(model, state.policies)
    sdt = adamw._state_dtype(opt_cfg)
    like = lambda dtype: tree_map(  # noqa: E731
        lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), params)
    opt = {"master": like(torch.float32), "m": like(sdt), "v": like(sdt),
           "count": torch.empty((), dtype=torch.int32, device="meta")}
    if opt_cfg.compression:
        opt["ef"] = like(sdt)

    def fn(params, grads, opt_state):
        fresh = tree_map(torch.clone, grads)
        p, s, _ = adamw.apply_updates(params, fresh, opt_state, opt_cfg, 1e-4)
        return p, s

    f, b = count_costs(fn, params, like(torch.float32), opt)
    return f, b, 0.0, {}


# ---------------------------------------------------------------------------
# Analytic kernel cores (per layer, GLOBAL numbers)
# ---------------------------------------------------------------------------


def _causal_context(S: int, window: int | None) -> float:
    """Mean #KV positions attended per query under causal(+window) masking."""
    if window is None or window >= S:
        return (S + 1) / 2.0
    # positions < window see t+1; the rest see `window`
    head = window * (window + 1) / 2.0
    return (head + (S - window) * window) / S


def attention_core_global(cfg: ModelConfig, B: int, S: int, *, train: bool,
                          mask: str, window: int | None, kv_heads: int | None = None,
                          n_heads: int | None = None) -> tuple[float, float]:
    """(flops, hbm_bytes) global, one layer, dense mode (flash-kernel shape)."""
    H = n_heads or cfg.n_heads
    K = kv_heads or cfg.kv_heads
    D = cfg.resolved_head_dim
    t_eff = _causal_context(S, window) if mask != "full" else float(S)
    fwd_flops = 2 * 2 * B * H * S * t_eff * D  # QK^T + PV
    fwd_bytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)  # q,o + k,v (bf16)
    if train:  # bwd ~2.5x fwd + full-remat recompute 1x
        return 4.5 * fwd_flops, 4.0 * fwd_bytes
    return fwd_flops, fwd_bytes


def wkv_core_global(cfg: ModelConfig, B: int, S: int, *, train: bool,
                    chunk: int = 32) -> tuple[float, float]:
    H = cfg.d_model // cfg.rwkv_head_dim
    C = cfg.rwkv_head_dim
    tokens = B * S
    fwd_flops = tokens * H * (6 * C * C + 4 * chunk * C)
    fwd_bytes = 2 * 5 * tokens * cfg.d_model  # r,k,v,w in + y out (bf16)
    if train:
        return 4.5 * fwd_flops, 4.0 * fwd_bytes
    return fwd_flops, fwd_bytes


# The cores' train counts hold one rerun of the forward: 4.5x its FLOPs
# (backward 2.5x) and 4.0x its bytes (backward 2x).  Under remat `none` the
# kernel runs once, and the least work is 3.5x and 3.0x the forward's.
NO_RERUN_SCALE = (3.5 / 4.5, 3.0 / 4.0)


def analytic_cores(cfg: ModelConfig, B: int, S: int, *, train: bool, remat: str,
                   wkv_chunk: int, chips: int) -> list[ComponentCost]:
    """The attention / WKV cores of a dense-mode step (per device), scaled
    to the remat woven: K1 and K6 rerun in the backward under any policy
    but `none` (`nn/stack.py`)."""
    fs, bs = NO_RERUN_SCALE if train and remat == "none" else (1.0, 1.0)

    def core(name, count, fl, by):
        return ComponentCost(name, count, fl * fs / chips, by * bs / chips, 0.0)

    if cfg.family in ("dense", "moe", "vlm"):
        fl, by = attention_core_global(cfg, B, S, train=train, mask="causal",
                                       window=cfg.attn_window)
        return [core("attn_core", cfg.num_layers, fl, by)]
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        n_att = sum(1 for i in range(cfg.num_layers) if pat[i % len(pat)] == "attn")
        fl, by = attention_core_global(cfg, B, S, train=train, mask="local",
                                       window=cfg.local_window)
        return [core("attn_core", n_att, fl, by)]
    if cfg.family == "encdec":
        fl_e, by_e = attention_core_global(cfg, B, S, train=train, mask="full",
                                           window=None)
        fl_s, by_s = attention_core_global(cfg, B, S, train=train, mask="causal",
                                           window=None)
        # decoder: causal self + full cross
        return [core("enc_attn_core", cfg.enc_layers or cfg.num_layers, fl_e, by_e),
                core("dec_attn_core", cfg.num_layers, fl_s + fl_e, by_s + by_e)]
    if cfg.family == "ssm":
        fl, by = wkv_core_global(cfg, B, S, train=train, chunk=wkv_chunk)
        return [core("wkv_core", cfg.num_layers, fl, by)]
    return []


# ---------------------------------------------------------------------------
# Cell composition
# ---------------------------------------------------------------------------


def compose_cell(arch: str, shape: ShapeConfig | str, *, mesh: Mesh | None = None,
                 overrides: dict | None = None, verbose: bool = True) -> dict:
    """The composed roofline of one (arch x shape) step on `mesh` (default:
    the card mesh).  `shape` is a name of `SHAPES` or any `ShapeConfig`, so
    the shapes the card actually runs can be costed."""
    from repro_torch.core.program import Program
    from repro_torch.launch.weave import default_weave
    from repro_torch.models.registry import get_config, input_specs
    from repro_torch.runtime.steps import step_flops

    cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh if mesh is not None else make_card_mesh()
    if mesh.size != 1:
        raise NotImplementedError(f"a mesh of {mesh.size} devices: {PARTITIONER_REASON}")
    chips = mesh.size

    program = Program.from_arch(arch, kind=shape.kind, device="meta")
    woven = default_weave(program, shape, dict(mesh.shape), overrides=overrides)
    state = woven.state
    model = program.model
    train = shape.kind == "train"
    accum = int(state.extra.get("accum_steps", 1)) if train else 1
    B_micro = shape.global_batch // accum
    S = shape.seq_len
    dec = shape.kind == "decode"
    B_blk, S_blk = (shape.global_batch, 1) if dec else (B_micro, S)
    remat = str(state.extra.get("remat", "full")) if train else "none"
    if cfg.family == "hybrid" and remat != "none":
        remat = "full"  # the unrolled blocks are checkpointed whole

    comps: list[ComponentCost] = []
    for name, block, count, cache_spec, kwargs in model.component_blocks(
            shape.global_batch, S):
        if dec and cache_spec is None:
            continue  # cache-less blocks (enc-dec encoder) do not run at decode
        # kwargs leaves (e.g. enc-dec kv_src) follow the block's batch dim
        kwargs_spec = {k: ((B_blk,) + tuple(v[0][1:]), v[1]) for k, v in kwargs.items()}
        f, b, c, ops = block_component(
            block, mesh, woven, B=B_blk, S=S_blk, d_model=cfg.d_model,
            mode="decode" if dec else ("dense" if train else "prefill"),
            train=train, remat=remat, cache_spec=cache_spec if dec else None,
            kwargs_spec=kwargs_spec,
        )
        comps.append(ComponentCost(name, count * accum, f, b, c, ops))

    specs = input_specs(cfg, shape)
    if train and accum > 1:
        micro = {k: ((B_micro,) + tuple(v[0][1:]), v[1])
                 for k, v in specs["inputs"].items()}
        specs = {"inputs": micro, "cache": None}
    f, b, c, ops = outer_component(woven, mesh, specs, train=train,
                                   mode="decode" if dec else shape.kind)
    comps.append(ComponentCost("outer", accum, f, b, c, ops))

    if train:
        f, b, c, ops = optimizer_component(woven, mesh)
        comps.append(ComponentCost("optimizer", 1, f, b, c, ops))

    if not dec:
        comps += analytic_cores(cfg, shape.global_batch, S, train=train, remat=remat,
                                wkv_chunk=int(state.extra.get("wkv_chunk", 32)),
                                chips=chips)

    tot_f = sum(c.total()[0] for c in comps)
    tot_b = sum(c.total()[1] for c in comps)
    tot_c = sum(c.total()[2] for c in comps)
    model_flops = step_flops(cfg, shape)

    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(mesh), "chips": chips,
        "method": "compositional",
        "components": [c.to_json() for c in comps],
        "flops_per_device": tot_f,
        "bytes_per_device": tot_b,
        "collective_bytes_per_device": tot_c,
        "model_flops": model_flops,
        "compute_s": tot_f / PEAK_FLOPS_BF16,
        "memory_s": tot_b / HBM_BW,
        "collective_s": tot_c / NVLINK_BW,
        "accum_steps": accum,
        "overrides": overrides or {},
    }
    terms = {"compute": result["compute_s"], "memory": result["memory_s"],
             "collective": result["collective_s"]}
    result["bottleneck"] = max(terms, key=terms.get)
    result["step_s"] = max(terms.values())
    counted = tot_f * chips
    result["useful_ratio"] = model_flops / counted if counted else 0.0
    result["roofline_fraction"] = (
        model_flops / (chips * PEAK_FLOPS_BF16 * result["step_s"])
        if result["step_s"] else 0.0
    )
    if verbose:
        print(f"[roofline {arch} x {shape.name} x {result['mesh']}] "
              f"compute={result['compute_s']*1e3:.2f}ms "
              f"memory={result['memory_s']*1e3:.2f}ms "
              f"collective={result['collective_s']*1e3:.2f}ms "
              f"-> {result['bottleneck']}-bound "
              f"useful={result['useful_ratio']:.2f} "
              f"frac={result['roofline_fraction']:.3f}")
    return result
