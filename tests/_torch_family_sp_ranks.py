"""Rank bodies of `tests/test_torch_mesh_families_sp.py`.  `run_on_mesh`
spawns each rank and imports this module there, so it imports the port and
torch only; every function takes the rank's live mesh last and returns host
values (rank 0's reach the test)."""

import numpy as np
import torch

from _torch_family_ranks import RouteSpy, every_rank, serve_entries, shapes, to_host
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
    seq_axis,
    tree_shards,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.weave import default_weave
from repro_torch.models.lm import whole_logits
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import init_params
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.steps import build_grad_fn, build_mesh_mean, build_train_step

ADAM_EPS = 1e-6
LR = 1e-3
VOCAB = 515  # divides neither a 2- nor a 4-way sequence axis
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16}
# each run: its arch, its mesh, the `embed` rule (None: AutoShard's own at
# the reduced size, `embed` whole), whether `fsdp_sp` is forced through
# AutoShard's `layout=` (else AutoShard picks it), the config's changes
# beyond head_dim 64 and a vocab of `VOCAB`, and its frames or image tokens
RUNS = {
    "mixtral-8x22b": ("mixtral-8x22b", (2, 2), None, True, {}, 0),
    "mixtral-8x22b+embed": ("mixtral-8x22b", (2, 2), ("data", "model"), True, {}, 0),
    "grok-1-314b": ("grok-1-314b", (2, 2), None, True, {}, 0),
    "whisper-small": ("whisper-small", (2, 2), None, True, {}, 16),
    "whisper-small+odd": ("whisper-small", (2, 2), None, True, {}, 15),
    # a vocab the axis divides: the table's rows split, the logits a vocab block
    "whisper-small+v512": ("whisper-small", (2, 2), None, True, {"vocab": 512}, 16),
    "internvl2-1b": ("internvl2-1b", (2, 2), None, True, {}, 8),
    # 6 heads on a 4-way `model` axis: AutoShard picks fsdp_sp by itself
    "internvl2-1b@1x4": ("internvl2-1b", (1, 4), None, False, {"n_heads": 6}, 8),
}
MOE = ("mixtral-8x22b", "grok-1-314b")


def config(run):
    arch, _, _, _, changes, _ = RUNS[run]
    return reduced_config(arch).replace(**{"head_dim": 64, "vocab": VOCAB, **changes})


def woven(run, kind, mesh_axes, overrides=None):
    """The run's reduced arch, fp32, the attention woven to the kernels,
    laid out on `mesh_axes` as the run says (unmeshed: `{}`)."""
    _, _, embed, forced, _, _ = RUNS[run]
    cfg = config(run)
    program = Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cpu")
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    aspects = [KernelAspect("*", "attention", "cuda")]
    if forced:
        aspects = [AutoShard(dict(mesh_axes), train=kind == "train", layout="fsdp_sp"),
                   ShardingAspect({"embed": embed})] + aspects
    w = default_weave(program, shape, dict(mesh_axes),
                      overrides={"tuned_kernels": False, "rules": {"embed": embed},
                                 **EXTRA, **(overrides or {})},
                      extra_aspects=aspects)
    w.state.policies = PolicyResolver.default("f32")
    return w


def side_inputs(run, rows, seed=5):
    """The run's inputs besides its tokens, `rows` rows from a seed: an
    encoder-decoder's frames, a VLM's image prefix (numpy, fp32)."""
    cfg = config(run)
    n = RUNS[run][5]
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((rows, n, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"embeds": (0.02 * rng.standard_normal((rows, n, cfg.d_model)))
                .astype(np.float32)}
    return {}


def whole_params(w, np_params):
    """The one-device param tree of `w`'s model, from the reference's."""
    init_params(w.program.model, 0, w.state.policies, "cpu")
    return load_jax_params(w.program.model, np_params)


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_MESHES = {}  # this rank's meshes of other shapes, by shape


def mesh_for(run, mesh):
    """The run's mesh over the ranks of `mesh`: made once per shape, by every
    rank in the same order."""
    shape = RUNS[run][1]
    if shape == mesh.axis_sizes:
        return mesh
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, backend=mesh.backend, device="cpu")
    return _MESHES[shape]


# -- (a, c) logits and routing -------------------------------------------------------

def logits(run, np_params, tokens, mesh):
    """The dense logits of `tokens` (with the run's side inputs) on this
    mesh, put back together whole (`whole_logits` over the sequence axis,
    then the rows), with every rank's routing decisions and its rows."""
    w = woven(run, "serve", mesh.shape)
    model, rules = w.program.model, w.state.rules
    params = tree_shards(whole_params(w, np_params),
                         param_shardings(model, mesh, rules), local_shard)
    feed = tensors({"tokens": tokens, **side_inputs(run, tokens.shape[0])})
    rows = input_shardings(feed, mesh, rules)
    feed = {k: local_shard(v, rows[k]) for k, v in feed.items()}
    with RouteSpy() as spy, torch.no_grad():
        out, _ = model(params, feed, ctx=w.state.make_ctx(mesh=mesh), mode="dense")
    block = tuple(out.shape)
    out = whole_logits(out, mesh, w.program.cfg.vocab, seq_axis(mesh, rules))
    out = gather_shards(out, rows["tokens"])
    mine = local_shard(torch.arange(tokens.shape[0]), rows["tokens"]).tolist()
    return {"logits": out.numpy(), "block": block, "layout": w.state.extra.get("layout"),
            "rules": dict(rules), "routing": every_rank(spy.calls, mesh),
            "rows": every_rank(mine, mesh)}


def moe_layer(run, np_params, x, mesh):
    """The first MoE layer alone on the rank's rows of `x` (B, S, dm), its
    block of the sequence: its output, its input's gradient and the
    `moe_drop_frac` tap, every rank's."""
    w = woven(run, "train", mesh.shape)
    model, rules = w.program.model, w.state.rules
    params = tree_shards(whole_params(w, np_params), param_shardings(model, mesh, rules),
                         local_shard)
    rows = input_shardings({"tokens": torch.zeros(x.shape[:2])}, mesh, rules)["tokens"]
    x = local_shard(torch.from_numpy(x), rows)
    sp = seq_axis(mesh, rules)
    size = x.shape[1] // mesh.shape[sp]
    xt = x.narrow(1, mesh.coord(sp) * size, size).clone().requires_grad_(True)
    ffn = model.trunk[0].template.ffn
    layer = {k: v[0] for k, v in params[model.trunk[0].name]["block"]["ffn"].items()}
    ctx = w.state.make_ctx(mesh=mesh)
    ctx.taps_enabled = ["*moe_drop_frac"]
    with torch.enable_grad():
        y = ffn(layer, xt, ctx=ctx)
        (dx,) = torch.autograd.grad(torch.sum(y * y), xt)
    return every_rank({"y": y.detach().numpy(), "dx": dx.numpy(), "coords": mesh.coords,
                       "drop": {k: float(v) for k, v in ctx.taps.items()}}, mesh)


# -- (b, d, e) train steps and gradients ----------------------------------------------

def train(run, np_params, batch, mesh):
    """One train step on this mesh: the whole parameters after it, its
    metrics, every rank's resident parameter and AdamW shapes, and the
    gradient of the initial weights put back together whole."""
    w = woven(run, "train", mesh.shape, {"accum_steps": 1, "remat": "full"})
    model, rules = w.program.model, w.state.rules
    shardings = param_shardings(model, mesh, rules)
    whole = whole_params(w, np_params)
    whole_shapes = shapes(whole)
    params = tree_shards(whole, shardings, local_shard)
    del whole
    feed = tensors(batch)
    rows = input_shardings(feed, mesh, rules)
    local = {k: local_shard(v, rows[k]) for k, v in feed.items()}
    _, mean = build_mesh_mean(w, mesh)
    (_, gm), grads = build_grad_fn(w, mesh)(params, local)
    grads, gm = mean(grads, gm)
    grads = to_host(tree_shards(grads, shardings, gather_shards))
    opt = adamw.init_state(params, adamw.AdamWConfig())
    step = build_train_step(w, mesh=mesh, lr_fn=lambda s: schedule.constant(s, peak=LR),
                            opt_cfg=adamw.AdamWConfig(eps=ADAM_EPS))
    collectives.reset_counts()
    params, opt, m = step(params, opt, feed, 0)
    counts = collectives.counts()
    resident = {"params": shapes(params), "m": shapes(opt["m"]), "v": shapes(opt["v"]),
                "master": shapes(opt["master"])}
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": to_host(tree_shards(params, shardings, gather_shards)),
            "grads": grads, "grad_loss": float(gm["loss"]), "counts": counts,
            "layout": w.state.extra.get("layout"), "rules": dict(rules),
            "resident": every_rank(resident, mesh), "whole_shapes": whole_shapes,
            "specs": tree_shards(shardings, shardings, lambda sh, _: sh.spec)}


def suite(np_by_run, tokens, batches, mesh):
    """(a)-(e) of every run, each on its mesh over the same four ranks."""
    out = {}
    for run, np_params in np_by_run.items():
        m = mesh_for(run, mesh)
        out[run] = {"logits": logits(run, np_params, tokens, m),
                    "train": train(run, np_params, batches[run], m)}
        if RUNS[run][0] in MOE and RUNS[run][2] is None:
            x = np.concatenate([c[0]["x"] for c in out[run]["logits"]["routing"][::2]])
            out[run]["moe_layer"] = moe_layer(run, np_params, x, m)
    return out


# -- (f) serving, checkpoints ---------------------------------------------------------

SERVE_TOKENS = np.random.default_rng(8).integers(0, 512, (2, 8)).astype(np.int32)


def serve_results(runs, mesh):
    """Each run's serving entry points under fsdp_sp: the prefill and a
    decode step's logits and the server's tokens (`serve_entries`)."""
    return {run: serve_entries(woven(run, "serve", mesh.shape if mesh is not None else {}),
                               SERVE_TOKENS, side_inputs(run, SERVE_TOKENS.shape[0]), mesh)
            for run in runs}


def trainer_checkpoint(run, ckpt_dir, mesh):
    """A meshed `Trainer` of the run: two steps, the whole state written by
    rank 0, then a fresh meshed trainer restoring it.  Every rank's
    agreement and resident shapes, rank 0's whole parameters."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def make():
        w = woven(run, "train", mesh.shape, {"accum_steps": 1})
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
    shardings = param_shardings(first.woven.program.model, mesh, first.woven.state.rules)
    whole = to_host(tree_shards(first.params, shardings, gather_shards))
    mine = (restored, second.step, same, shapes(second.params),
            [h["loss"] for h in first.history])
    return every_rank(mine, mesh), whole


def reshard(run, ckpt_dir, mesh):
    """`reshard_params` of a one-device checkpoint onto this mesh under the
    run's rules: whether each rank's blocks are the whole leaves split by
    hand, with the shapes."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import reshard_params

    w = woven(run, "train", mesh.shape)
    model, rules = w.program.model, w.state.rules
    template = init_params(model, 3, device="cpu")
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    placed, manifest = reshard_params(model, ckpt, mesh, rules, template, 5)
    whole, _ = ckpt.restore({"params": template}, 5)
    shardings = param_shardings(model, mesh, rules)
    verdicts = []

    def walk(got, want, sh, path=""):
        if isinstance(got, dict):
            for k in got:
                walk(got[k], want[k], sh[k], f"{path}/{k}")
            return
        verdicts.append((path, tuple(got.shape), tuple(want.shape),
                         torch.equal(got, local_shard(want, sh))))

    walk(placed, whole["params"], shardings)
    return manifest["step"], every_rank(verdicts, mesh)


def apart(runs, ckpt_run, ckpt_dir, reshard_run, reshard_dir, mesh):
    """The served entry points, a meshed trainer's checkpoint and a
    reshard, in one spawn."""
    return {"served": serve_results(runs, mesh),
            "trainer": trainer_checkpoint(ckpt_run, ckpt_dir, mesh),
            "reshard": reshard(reshard_run, reshard_dir, mesh)}
