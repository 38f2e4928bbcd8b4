"""Rank bodies of `tests/test_torch_mesh_families.py`.  `run_on_mesh` spawns
each rank and imports this module there, so it imports the port and torch
only; every function takes the rank's live mesh last and returns host
values (rank 0's reach the test)."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.core.strategies.parallelization import AutoShard
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    gather_shards,
    input_shardings,
    local_shard,
    param_shardings,
    tree_shards,
)
from repro_torch.launch.weave import default_weave
from repro_torch.models.lm import whole_logits
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn import moe
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import init_params
from repro_torch.optim import adamw, schedule
from repro_torch.optim.tree import leaves
from repro_torch.runtime.steps import build_train_step

ADAM_EPS = 1e-6
LR = 1e-3
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16}
# each run: its arch and the `embed` rule carried over from the published
# size (None: AutoShard's own rule at the reduced size, `embed` whole;
# whisper-small's, which AutoShard leaves whole at every size, set by hand
# to hold the encoder-decoder's FSDP gathers).  Every run is AutoShard's
# own `megatron_tp`.
RUNS = {
    "mixtral-8x22b": ("mixtral-8x22b", None),
    "mixtral-8x22b+embed": ("mixtral-8x22b", ("data",)),
    "grok-1-314b": ("grok-1-314b", None),
    "whisper-small": ("whisper-small", None),
    "whisper-small+embed": ("whisper-small", ("data",)),
    "internvl2-1b": ("internvl2-1b", None),
}
ENC_LEN = 16     # whisper's encoder frames at the reduced size
IMAGE_TOKENS = 8  # internvl's image prefix at the reduced size (its reduced config's)


def woven(run, kind, mesh_axes, overrides=None):
    """The run's reduced arch at head_dim 64 (the kernels' plain versions
    run), fp32, the attention woven to the kernels, laid out by AutoShard
    for `mesh_axes` (its `embed` rule replaced where the run names one)."""
    arch, embed = RUNS[run]
    cfg = reduced_config(arch).replace(head_dim=64)
    program = Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cpu")
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    rules = {"rules": {"embed": embed}} if embed else {}
    w = default_weave(program, shape, dict(mesh_axes),
                      overrides={"tuned_kernels": False, **rules, **EXTRA,
                                 **(overrides or {})},
                      extra_aspects=[KernelAspect("*", "attention", "cuda")])
    w.state.policies = PolicyResolver.default("f32")
    return w


def side_inputs(run, rows, seed=5):
    """The run's inputs besides its tokens, `rows` rows from a seed: an
    encoder-decoder's frames, a VLM's image prefix (numpy, fp32)."""
    cfg = reduced_config(RUNS[run][0])
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((rows, ENC_LEN, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"embeds": (0.02 * rng.standard_normal((rows, IMAGE_TOKENS, cfg.d_model)))
                .astype(np.float32)}
    return {}


def whole_params(w, np_params):
    """The one-device param tree of `w`'s model, from the reference's."""
    init_params(w.program.model, 0, w.state.policies, "cpu")
    return load_jax_params(w.program.model, np_params)


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def every_rank(obj, mesh):
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class RouteSpy:
    """Records every `MoEMLP.route` call's input and decisions: the grouped
    tokens it read, each (token, k)'s expert, its rank within the expert's
    group and whether it was kept (rank < capacity)."""

    def __init__(self):
        self.calls = []
        self._real = moe.MoEMLP.route

    def __enter__(self):
        spy = self

        def route(module, params, xc, policy):
            out = spy._real(module, params, xc, policy)
            _, tope, _, rank = out
            grp = xc.shape[1]
            cap = moe.capacity(grp, module.top_k, module.capacity_factor,
                               module.num_experts)
            spy.calls.append({"x": xc.detach().float().numpy(),
                              "experts": tope.numpy().astype(np.int64),
                              "ranks": rank.numpy().astype(np.int64),
                              "keep": (rank < cap).numpy(), "capacity": cap})
            return out

        moe.MoEMLP.route = route
        return self

    def __exit__(self, *exc):
        moe.MoEMLP.route = self._real


# -- (a, b) logits and routing ----------------------------------------------------

def logits(run, np_params, tokens, mesh):
    """The dense logits of `tokens` (with the run's side inputs) on this
    mesh, put back together whole, and every rank's routing decisions."""
    w = woven(run, "serve", mesh.shape)
    model, rules = w.program.model, w.state.rules
    params = tree_shards(whole_params(w, np_params),
                         param_shardings(model, mesh, rules), local_shard)
    feed = _tensors({"tokens": tokens, **side_inputs(run, tokens.shape[0])})
    rows = input_shardings(feed, mesh, rules)
    feed = {k: local_shard(v, rows[k]) for k, v in feed.items()}
    with RouteSpy() as spy, torch.no_grad():
        out, _ = model(params, feed, ctx=w.state.make_ctx(mesh=mesh), mode="dense")
    out = gather_shards(whole_logits(out, mesh, w.program.cfg.vocab), rows["tokens"])
    return {"logits": out.numpy(), "layout": w.state.extra.get("layout"),
            "rules": dict(rules), "routing": every_rank(spy.calls, mesh),
            "coords": every_rank(mesh.coords, mesh)}


# -- (c, e) train steps -------------------------------------------------------------

def train(run, np_params, batch, mesh):
    """One train step on this mesh: the whole parameters after it, its
    metrics, and every rank's resident parameter and AdamW shapes."""
    w = woven(run, "train", mesh.shape, {"accum_steps": 1, "remat": "full"})
    model = w.program.model
    shardings = param_shardings(model, mesh, w.state.rules)
    whole = whole_params(w, np_params)
    whole_shapes = shapes(whole)
    params = tree_shards(whole, shardings, local_shard)
    del whole
    opt = adamw.init_state(params, adamw.AdamWConfig())
    step = build_train_step(w, mesh=mesh, lr_fn=lambda s: schedule.constant(s, peak=LR),
                            opt_cfg=adamw.AdamWConfig(eps=ADAM_EPS))
    collectives.reset_counts()
    params, opt, m = step(params, opt, _tensors(batch), 0)
    counts = collectives.counts()
    resident = {"params": shapes(params), "m": shapes(opt["m"]), "v": shapes(opt["v"]),
                "master": shapes(opt["master"])}
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": to_host(tree_shards(params, shardings, gather_shards)),
            "counts": counts, "layout": w.state.extra.get("layout"),
            "resident": every_rank(resident, mesh), "whole_shapes": whole_shapes,
            "specs": tree_shards(shardings, shardings, lambda sh, _: sh.spec)}


def moe_layer(run, np_params, x, mesh):
    """The first MoE layer alone on this rank's blocks, its input `x`
    replicated: its output and its input's gradient (the router's share
    and the experts' summed once), and the all-reduces over `model` its
    forward and its backward made."""
    w = woven(run, "train", mesh.shape)
    model, rules = w.program.model, w.state.rules
    params = tree_shards(whole_params(w, np_params), param_shardings(model, mesh, rules),
                         local_shard)
    ffn = model.trunk[0].template.ffn
    layer = {k: v[0] for k, v in params[model.trunk[0].name]["block"]["ffn"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ctx = w.state.make_ctx(mesh=mesh)

    def calls():
        return collectives.counts().get("all_reduce", {}).get("model", {}).get("calls", 0)

    collectives.reset_counts()
    with torch.enable_grad():
        y = ffn(layer, xt, ctx=ctx)
        fwd = calls()
        (dx,) = torch.autograd.grad(torch.sum(y * y), xt)
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "forward": fwd,
            "backward": calls() - fwd}


def suite(np_by_run, tokens, batches, mesh):
    """(a), (b), (c) and (e) of every run in one spawn of the mesh."""
    out = {}
    for run, np_params in np_by_run.items():
        out[run] = {"logits": logits(run, np_params, tokens, mesh),
                    "train": train(run, np_params, batches[run], mesh)}
        if RUNS[run][0] == "mixtral-8x22b" and RUNS[run][1] is None:
            x = out[run]["logits"]["routing"][0][0]["x"][:1]
            out[run]["moe_layer"] = moe_layer(run, np_params, x, mesh)
    return out


# -- (d) serving -------------------------------------------------------------------

def serve_one(run, np_params, requests, mesh=None):
    """Greedy tokens of the run's server (on `mesh`, or unmeshed): the MoE
    family through `serve_continuous` (mixtral's prompts pass its window:
    a ring pool) and `serve_batch` (dense ring caches), the others through
    `serve` with their side inputs; with what the server's caches held."""
    from repro_torch.runtime.server import Server, ServerConfig

    w = woven(run, "serve", mesh.shape if mesh is not None else {})
    params = whole_params(w, np_params)
    if mesh is not None:
        params = tree_shards(params, param_shardings(w.program.model, mesh,
                                                     w.state.rules), local_shard)
    srv = Server(w, ServerConfig(max_cache_len=64, decode_tokens=5, page_size=8),
                 params=params, mesh=mesh, device="cpu")
    family = w.program.cfg.family
    out = {"layout": w.state.extra.get("layout")}
    if family == "moe":
        out["tokens"] = [list(map(int, t)) for t in srv.serve_continuous(requests["prompts"])]
        out["pool"] = dict(srv.last_pool_stats)
        out["batch"] = [b.tolist() for b in srv.serve_batch(requests["prompts"])]
        return out
    tokens = requests["tokens"]
    extra = side_inputs(run, tokens.shape[0])
    if family == "encdec":
        out["cross"] = _cross_cache_unwritten(srv, tokens, extra)
    out["tokens"] = srv.serve(tokens, inputs=extra).tolist()
    return out


def _cross_cache_unwritten(srv, tokens, extra):
    """Whether one prefill's cross caches come back from two decode steps
    as the same tensors, unchanged, holding the rank's KV heads."""
    toks = torch.from_numpy(tokens).to(torch.int32)
    feed = {"tokens": toks, **_tensors(extra)}
    variant = srv._begin()
    logits, cache = srv.prefill_vc(variant, srv.params, feed)
    cross = cache["decoder"]["cross"]
    before = {k: v.clone() for k, v in cross.items()}
    pos = toks.shape[1]
    for _ in range(2):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, cache = srv.decode_vc(variant, srv.params, {
            "tokens": tok, "positions": torch.full_like(tok, pos)}, cache)
        pos += 1
    after = cache["decoder"]["cross"]
    return {"same": all(after[k] is cross[k] for k in cross),
            "unchanged": all(torch.equal(after[k], before[k]) for k in cross),
            "heads": int(after["ck"].shape[-2])}


def serving(np_by_run, requests, mesh):
    """(d) for every run in one spawn of the mesh."""
    return {run: serve_one(run, np_params, requests, mesh)
            for run, np_params in np_by_run.items()}


# -- serving under fsdp_sp ------------------------------------------------------------

def serve_entries(w, tokens, side, mesh=None):
    """The serving entry points of `w` (on `mesh`, or unmeshed) over the
    weights drawn from seed 0 (on a mesh, the rank's blocks of them): the
    prefill step's and one decode step's whole logits (fp32 numpy), and the
    server's greedy tokens of `tokens` with their side inputs."""
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    model = w.program.model
    shardings = None if mesh is None else param_shardings(model, mesh, w.state.rules)
    params = init_params(model, 0, w.state.policies, "cpu", shardings=shardings)
    w.state.extra["cache_max_len"] = 16
    feed = {"tokens": torch.from_numpy(tokens), **_tensors(side)}
    logits, cache = build_prefill_step(w, mesh=mesh)(params, feed)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    pos = tokens.shape[1] + (side["embeds"].shape[1] if "embeds" in side else 0)
    step, _ = build_decode_step(w, mesh=mesh)(
        params, {"tokens": tok, "positions": torch.full_like(tok, pos)}, cache)
    srv = Server(w, ServerConfig(max_cache_len=16, decode_tokens=3), params=params,
                 mesh=mesh, device="cpu")
    return {"prefill": logits[:, -1].float().numpy(), "decode": step[:, -1].float().numpy(),
            "server": srv.serve(tokens, inputs=side).tolist(),
            "layout": w.state.extra.get("layout")}


def fsdp_sp_woven(run, mesh_axes):
    """The run's reduced arch at head_dim 64, fp32, under AutoShard's
    `layout="fsdp_sp"` (what its published width picks on the pod); no
    layout without a mesh."""
    arch, _ = RUNS[run]
    cfg = reduced_config(arch).replace(head_dim=64)
    program = Program(model=build_model(cfg), cfg=cfg, kind="serve", device="cpu")
    aspects = [AutoShard(dict(mesh_axes), train=False, layout="fsdp_sp")] if mesh_axes else []
    w = default_weave(program, SHAPES["prefill_32k"], dict(mesh_axes),
                      overrides={"tuned_kernels": False}, extra_aspects=aspects)
    w.state.policies = PolicyResolver.default("f32")
    return w


FSDP_SP_TOKENS = np.random.default_rng(9).integers(0, 512, (2, 8)).astype(np.int32)


def fsdp_sp(runs, mesh):
    """Each run served under AutoShard's `layout="fsdp_sp"`: its entry
    points' results (`serve_entries`)."""
    return {f"{run}/serve": serve_entries(fsdp_sp_woven(run, mesh.shape), FSDP_SP_TOKENS,
                                          side_inputs(run, FSDP_SP_TOKENS.shape[0]), mesh)
            for run in runs}


# -- rwkv6-3b's gradient at depth -----------------------------------------------------

def rwkv_gradient(layers, batch, mesh=None):
    """The fp32 gradient of one batch for reduced rwkv6-3b at `layers`
    layers under AutoShard's `dp_fsdp` with its published `embed` rule
    over (data, model) — on this mesh (each rank's rows, reduced by the
    train step's `build_mesh_mean`, the blocks gathered whole) or
    unmeshed."""
    from repro_torch.runtime.steps import build_grad_fn, build_mesh_mean

    cfg = reduced_config("rwkv6-3b").replace(num_layers=layers)
    program = Program(model=build_model(cfg), cfg=cfg, kind="train", device="cpu")
    w = default_weave(program, SHAPES["train_4k"], dict(mesh.shape) if mesh else {},
                      overrides={"tuned_kernels": False, "accum_steps": 1, "remat": "full",
                                 "rules": {"embed": ("data", "model")}})
    w.state.policies = PolicyResolver.default("f32")
    params = init_params(program.model, 7, w.state.policies, "cpu")
    batch = _tensors(batch)
    if mesh is None:
        (loss, _), grads = build_grad_fn(w)(params, batch)
        return {"loss": float(loss), "grads": to_host(grads)}
    rules = w.state.rules
    shardings = param_shardings(program.model, mesh, rules)
    params = tree_shards(params, shardings, local_shard)
    rows = input_shardings(batch, mesh, rules)
    local = {k: local_shard(v, rows[k]) for k, v in batch.items()}
    _, mean = build_mesh_mean(w, mesh)
    (_, metrics), grads = build_grad_fn(w, mesh)(params, local)
    grads, metrics = mean(grads, metrics)
    return {"loss": float(metrics["loss"]), "layout": w.state.extra.get("layout"),
            "rules": dict(rules),
            "grads": to_host(tree_shards(grads, shardings, gather_shards))}


def local_draws(run, mesh):
    """`init_params(..., local=True)` of the run's model on this mesh: every
    rank's leaves (its blocks, drawn alone) and their block coordinates."""
    from repro_torch.distributed.sharding import block_coords

    w = woven(run, "serve", mesh.shape)
    shardings = param_shardings(w.program.model, mesh, w.state.rules)
    params = init_params(w.program.model, 3, w.state.policies, "cpu", shardings=shardings,
                         local=True)
    coords = tree_shards(shardings, shardings, lambda sh, _: block_coords(sh))
    return every_rank({"params": to_host(params), "coords": coords}, mesh)


def apart(runs, layers, batch, mesh):
    """The families served under `fsdp_sp`, rwkv6-3b's meshed gradient and the
    local draws, in one spawn."""
    return {"fsdp_sp": fsdp_sp(runs, mesh), "rwkv": rwkv_gradient(layers, batch, mesh),
            "local_draws": local_draws("mixtral-8x22b", mesh)}
