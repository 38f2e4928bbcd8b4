"""Rank bodies of `tests/test_torch_mesh_fsdp.py`.  `run_on_mesh` spawns each
rank and imports this module there, so it imports the port and torch only;
every function takes the rank's live mesh last and returns host values
(rank 0's reach the test)."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.core.strategies.parallelization import AutoShard, ShardingAspect
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
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import init_params
from repro_torch.optim import adamw, schedule
from repro_torch.optim.tree import leaves
from repro_torch.runtime.steps import build_train_step

ADAM_EPS = 1e-6
LR = 1e-3
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16}
# each arch's layout and FSDP rule: AutoShard's own choice of layout (gemma-2b's
# pod layout forced through its `layout=`), the `embed` rule of the published
# size carried to the reduced one through the `rules` override
LAYOUTS = {
    "rwkv6-3b": ("dp_fsdp", ("data", "model")),
    "recurrentgemma-2b": ("dp_fsdp", ("data", "model")),
    "gemma-2b": ("fsdp_sp", ("data", "model")),
    "qwen2-72b": ("megatron_tp", ("data",)),
}


def woven(arch, kind, mesh_axes, overrides=None):
    """Reduced `arch` at head_dim 64 (the kernels' plain versions run), fp32,
    the attention woven to the kernels, laid out as `LAYOUTS` says."""
    layout, embed = LAYOUTS[arch]
    cfg = reduced_config(arch).replace(head_dim=64)
    program = Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cpu")
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    aspects = [KernelAspect("*", "attention", "cuda")]
    if layout == "fsdp_sp":  # AutoShard's `layout=` override, then the rule
        aspects = [AutoShard(dict(mesh_axes), train=kind == "train", layout=layout),
                   ShardingAspect({"embed": embed})] + aspects
    w = default_weave(program, shape, dict(mesh_axes),
                      overrides={"tuned_kernels": False, "rules": {"embed": embed},
                                 **EXTRA, **(overrides or {})},
                      extra_aspects=aspects)
    w.state.policies = PolicyResolver.default("f32")
    return w


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


# -- (a) logits ----------------------------------------------------------------

def logits(arch, np_params, tokens, mesh):
    """The dense logits of `tokens` on this mesh, put back together whole:
    the vocab over `model`, the rows over the batch's axes."""
    w = woven(arch, "serve", mesh.shape)
    model, rules = w.program.model, w.state.rules
    params = tree_shards(whole_params(w, np_params),
                         param_shardings(model, mesh, rules), local_shard)
    toks = torch.from_numpy(tokens)
    rows = input_shardings({"tokens": toks}, mesh, rules)["tokens"]
    collectives.reset_counts()
    with torch.no_grad():
        out, _ = model(params, {"tokens": local_shard(toks, rows)},
                       ctx=w.state.make_ctx(mesh=mesh), mode="dense")
    counts = collectives.counts()
    out = gather_shards(whole_logits(out, mesh, w.program.cfg.vocab), rows)
    return out.numpy(), w.state.extra.get("layout"), dict(rules), counts


# -- (b, c, f) train steps ---------------------------------------------------------

def train(arch, np_params, batches, mesh):
    """`len(batches)` train steps on this mesh; the whole parameters after
    them, the metrics, the collectives of the first step and the axes it
    summed each leaf's gradient over (a spy on `steps._sum_over`, the
    gradient mean's all-reduces), every rank's resident parameter and
    AdamW shapes and bytes, and the whole shapes."""
    from repro_torch.runtime import steps

    w = woven(arch, "train", mesh.shape, {"accum_steps": 1, "remat": "full"})
    model = w.program.model
    shardings = param_shardings(model, mesh, w.state.rules)
    whole = whole_params(w, np_params)
    whole_shapes = shapes(whole)
    params = tree_shards(whole, shardings, local_shard)
    del whole
    opt = adamw.init_state(params, adamw.AdamWConfig())
    step = build_train_step(w, mesh=mesh, lr_fn=lambda s: schedule.constant(s, peak=LR),
                            opt_cfg=adamw.AdamWConfig(eps=ADAM_EPS))
    sums, real = [], steps._sum_over

    def spy(x, mesh_, axes):
        sums.append(tuple(axes))
        return real(x, mesh_, axes)

    metrics, counts = [], None
    for i, batch in enumerate(batches):
        collectives.reset_counts()
        steps._sum_over = spy if i == 0 else real
        try:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in
                                                batch.items()}, i)
        finally:
            steps._sum_over = real
        counts = counts or collectives.counts()
        metrics.append({k: float(v) for k, v in m.items()})
    n = len(leaves(params))
    resident = {"params": shapes(params), "m": shapes(opt["m"]), "v": shapes(opt["v"]),
                "master": shapes(opt["master"]),
                "bytes": sum(t.numel() * t.element_size() for t in
                             leaves(params) + leaves(opt["master"]) + leaves(opt["m"])
                             + leaves(opt["v"]))}
    out = to_host(tree_shards(params, shardings, gather_shards))
    return {"metrics": metrics, "params": out, "counts": counts,
            "grad_sums": sums[:n], "metric_sums": sums[n:],
            "layout": w.state.extra.get("layout"), "rules": dict(w.state.rules),
            "resident": every_rank(resident, mesh), "whole_shapes": whole_shapes,
            "specs": tree_shards(shardings, shardings, lambda sh, _: sh.spec)}


def suite(np_by_arch, tokens, batches, mesh):
    """(a), (b), (c) and (f) of every arch in one spawn of the mesh."""
    out = {}
    for arch, np_params in np_by_arch.items():
        got, layout, rules, counts = logits(arch, np_params, tokens, mesh)
        out[arch] = {"logits": got, "logits_layout": layout, "logits_rules": rules,
                     "logits_counts": counts,
                     "train": train(arch, np_params, batches, mesh)}
    return out


# -- (d) serving -----------------------------------------------------------------

def serve(arch, prompts, solo, mesh):
    """Greedy `serve_batch` of `prompts` and `serve` of `solo` on this
    mesh, the rows each rank served, and the FSDP gathers it made."""
    from repro_torch.runtime.server import Server, ServerConfig

    w = woven(arch, "serve", mesh.shape)
    srv = Server(w, ServerConfig(max_cache_len=48, decode_tokens=5), mesh=mesh,
                 device="cpu")
    collectives.reset_counts()
    batch = srv.serve_batch(prompts)
    counts = collectives.counts()
    one = srv.serve(solo)
    mine = local_shard(torch.arange(len(prompts)), srv._rows(len(prompts))).tolist()
    return {"batch": [b.tolist() for b in batch], "solo": one.tolist(),
            "layout": w.state.extra.get("layout"), "rows": every_rank(mine, mesh),
            "counts": counts}


def serving(archs, prompts, solo, mesh):
    """(d) for every arch and gemma-2b's entry points under `fsdp_sp`, in
    one spawn of the mesh."""
    out = {arch: serve(arch, prompts, solo, mesh) for arch in archs}
    out["fsdp_sp_serving"] = fsdp_sp_serving(mesh)
    return out


# -- (e) checkpoints --------------------------------------------------------------

def trainer_checkpoint(arch, ckpt_dir, mesh):
    """A meshed FSDP `Trainer`: two steps, the whole state written by rank 0,
    then a fresh meshed trainer restoring it.  Returns every rank's
    agreement and resident shapes, rank 0's whole parameters and the
    manifest's process fields."""
    import json
    import os

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def make():
        w = woven(arch, "train", mesh.shape, {"accum_steps": 1})
        return Trainer(w, TokenPipeline(PipelineConfig(vocab=512, seq_len=16,
                                                       global_batch=4)),
                       TrainerConfig(steps=2, ckpt_dir=ckpt_dir, ckpt_every=2,
                                     log_every=0), mesh=mesh)

    first = make()
    first.run(2)
    second = make()
    restored = second.maybe_restore()
    same = all(torch.equal(a, b) for a, b in
               zip(leaves(first.params), leaves(second.params)))
    same = same and all(torch.equal(a, b) for a, b in
                        zip(leaves(first.opt_state), leaves(second.opt_state)))
    with open(os.path.join(ckpt_dir, "ckpt_2", "manifest.json")) as f:
        manifest = json.load(f)
    shardings = param_shardings(first.woven.program.model, mesh, first.woven.state.rules)
    whole = to_host(tree_shards(first.params, shardings, gather_shards))
    mine = (restored, second.step, same, shapes(second.params))
    return every_rank(mine, mesh), whole, (manifest["process_index"],
                                           manifest["process_count"])


def checkpoints(arch, ckpt_dir, reshard_dirs, mesh):
    """(e) in one spawn of the mesh: the FSDP trainer's checkpoint, and
    `reshard` of each {arch: checkpoint dir}."""
    return {"trainer": trainer_checkpoint(arch, ckpt_dir, mesh),
            "reshard": {a: reshard(a, d, mesh) for a, d in reshard_dirs.items()}}


def reshard(arch, ckpt_dir, mesh):
    """`reshard_params` of a one-device checkpoint onto this mesh under the
    arch's FSDP rules: each rank's blocks against the whole leaves split
    by hand."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import reshard_params

    w = woven(arch, "train", mesh.shape)
    model, rules = w.program.model, w.state.rules
    template = init_params(model, 3, device="cpu")
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    placed, manifest = reshard_params(model, ckpt, mesh, rules, template, 5)
    whole, _ = ckpt.restore({"params": template}, 5)
    verdicts = []

    def walk(got, want, sh, path=""):
        if isinstance(got, dict):
            for k in got:
                walk(got[k], want[k], sh[k], f"{path}/{k}")
            return
        expect = want  # this rank's block by hand: row-major over each entry's axes
        for dim, entry in enumerate(sh.spec):
            if entry is None:
                continue
            n, idx = 1, 0
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coord(a)
            expect = torch.chunk(expect, n, dim=dim)[idx]
        verdicts.append((path, tuple(got.shape), tuple(want.shape),
                         got.dtype == want.dtype and torch.equal(got, expect)))

    walk(placed, whole["params"], param_shardings(model, mesh, rules))
    return manifest["step"], every_rank(verdicts, mesh)


# -- serving under fsdp_sp ----------------------------------------------------------

SP_TOKENS = np.random.default_rng(10).integers(0, 512, (2, 8)).astype(np.int32)


def fsdp_sp_serving(mesh):
    """gemma-2b's serving entry points under `fsdp_sp` with its FSDP rule
    over (data, model): the prefill and a decode step's logits and the
    server's tokens (`serve_entries`; unmeshed where `mesh` is None)."""
    from _torch_family_ranks import serve_entries

    return serve_entries(woven("gemma-2b", "serve", mesh.shape if mesh is not None else {}),
                         SP_TOKENS, {}, mesh)
