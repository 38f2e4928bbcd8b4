"""Rank bodies of `tests/test_torch_mesh_parallel.py`.  `run_on_mesh` spawns
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
from repro_torch.runtime.steps import build_train_step

ADAM_EPS = 1e-6
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16}


def woven(arch, kind, mesh_axes, overrides=None, head_dim=64, aspects=()):
    """Reduced `arch` (head_dim 64: the kernels' plain versions run), fp32,
    the attention woven to the kernels, the layout AutoShard picks for
    `mesh_axes` (or `aspects` put in its place)."""
    cfg = reduced_config(arch)
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim)
    program = Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cpu")
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    w = default_weave(program, shape, dict(mesh_axes),
                      overrides={"tuned_kernels": False, **EXTRA, **(overrides or {})},
                      extra_aspects=[*aspects, KernelAspect("*", "attention", "cuda")])
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


# -- (a) K1 ------------------------------------------------------------------

def flash(cases, mesh):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    rules = {"batch": ("data",), "heads": "model", "kv_heads": "model"}
    out = []
    for q, k, v in cases:
        o = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, mesh=mesh, rules=rules)
        out.append(o.numpy())
    return out


# -- (b) logits ----------------------------------------------------------------

def logits(arch, np_params, tokens, mesh):
    w = woven(arch, "serve", mesh.shape)
    model = w.program.model
    rules = w.state.rules
    params = tree_shards(whole_params(w, np_params),
                         param_shardings(model, mesh, rules), local_shard)
    toks = torch.from_numpy(tokens)
    toks = local_shard(toks, input_shardings({"tokens": toks}, mesh, rules)["tokens"])
    with torch.no_grad():
        out, _ = model(params, {"tokens": toks}, ctx=w.state.make_ctx(mesh=mesh),
                       mode="dense")
    out = collectives.all_gather(whole_logits(out, mesh, w.program.cfg.vocab),
                                 mesh, "data", 0)
    return out.numpy(), w.state.extra.get("layout"), dict(rules)


def vocab_split(logits, labels, mesh):
    """`greedy_argmax` and `vocab_cross_entropy` over this rank's vocab block
    of the whole `logits`."""
    from repro_torch.models.lm import greedy_argmax, vocab_cross_entropy

    x = torch.from_numpy(logits)
    n = x.shape[-1] // mesh.shape["model"]
    mine = x[..., mesh.coord("model") * n:(mesh.coord("model") + 1) * n]
    nll = vocab_cross_entropy(mine, torch.from_numpy(labels), mesh)
    return greedy_argmax(mine, mesh, x.shape[-1]).numpy(), nll.numpy()


# -- (c, f) one train step ----------------------------------------------------------

def train(arch, np_params, batches, mesh):
    w = woven(arch, "train", mesh.shape, {"accum_steps": 1, "remat": "full"})
    model = w.program.model
    shardings = param_shardings(model, mesh, w.state.rules)
    params = tree_shards(whole_params(w, np_params), shardings, local_shard)
    opt = adamw.init_state(params, adamw.AdamWConfig())
    step = build_train_step(w, mesh=mesh,
                            lr_fn=lambda s: schedule.constant(s, peak=1e-3),
                            opt_cfg=adamw.AdamWConfig(eps=ADAM_EPS))
    collectives.reset_counts()
    metrics = []
    for i, batch in enumerate(batches):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in
                                            batch.items()}, i)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = collectives.counts()
    whole = to_host(tree_shards(params, shardings, gather_shards))
    return metrics, whole, counts


# -- (d) serving -----------------------------------------------------------------

def serve(arch, prompts, mesh):
    from repro_torch.runtime.server import Server, ServerConfig

    w = woven(arch, "serve", mesh.shape)
    srv = Server(w, ServerConfig(max_cache_len=48, decode_tokens=5, page_size=8),
                 mesh=mesh, device="cpu")
    batch = srv.serve_batch(prompts)
    cont = srv.serve_continuous(prompts)
    return ([b.tolist() for b in batch], [list(map(int, c)) for c in cont],
            srv.last_pool_stats)


# -- (e) elastic restore ---------------------------------------------------------

def reshard(ckpt_dir, rules, mesh):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import plan_rescale, reshard_params

    program = Program.from_arch("yi-6b", kind="train", reduced=True, device="cpu")
    template = init_params(program.model, 3, device="cpu")
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    placed, manifest = reshard_params(program.model, ckpt, mesh, rules, template, 5)
    whole, _ = ckpt.restore({"params": template}, 5)
    shardings = param_shardings(program.model, mesh, rules)
    verdicts = []

    def check(path, got, want, sh):
        # this rank's block by hand: split each sharded dim into its extent
        expect = want
        for dim, entry in enumerate(sh.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, idx = 1, 0
            for a in axes:
                n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coord(a)
            expect = torch.chunk(expect, n, dim=dim)[idx]
        verdicts.append((path, tuple(got.shape), got.dtype == want.dtype
                         and torch.equal(got, expect)))

    def walk(got, want, sh, path=""):
        if isinstance(got, dict):
            for k in got:
                walk(got[k], want[k], sh[k], f"{path}/{k}")
        else:
            check(path, got, want, sh)

    walk(placed, whole["params"], shardings)
    every = [None] * mesh.size
    dist.all_gather_object(every, verdicts)
    return manifest["step"], plan_rescale(8, mesh, rules), every


def trainer_checkpoint(ckpt_dir, mesh):
    """A meshed `Trainer` of reduced yi-6b: two steps, a checkpoint of the
    whole state written by rank 0, then a fresh meshed trainer restoring
    it.  Returns the restored blocks' agreement on every rank, rank 0's
    whole parameters and the manifest's process fields."""
    import json
    import os

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def make():
        w = woven("yi-6b", "train", mesh.shape, {"accum_steps": 1}, head_dim=None)
        return Trainer(w, TokenPipeline(PipelineConfig(vocab=512, seq_len=16,
                                                       global_batch=4)),
                       TrainerConfig(steps=2, ckpt_dir=ckpt_dir, ckpt_every=2,
                                     log_every=0), mesh=mesh)

    first = make()
    first.run(2)
    second = make()
    restored = second.maybe_restore()
    same = all(torch.equal(a, b) for a, b in
               zip(leaves_of(first.params), leaves_of(second.params)))
    same = same and all(torch.equal(a, b) for a, b in
                        zip(leaves_of(first.opt_state), leaves_of(second.opt_state)))
    with open(os.path.join(ckpt_dir, "ckpt_2", "manifest.json")) as f:
        manifest = json.load(f)
    shardings = param_shardings(first.woven.program.model, mesh, first.woven.state.rules)
    whole = to_host(tree_shards(first.params, shardings, gather_shards))
    every = [None] * mesh.size
    dist.all_gather_object(every, (restored, second.step, same))
    return every, whole, (manifest["process_index"], manifest["process_count"])


def leaves_of(tree):
    from repro_torch.optim.tree import leaves

    return leaves(tree)


# -- (g) what a live mesh refuses ----------------------------------------------------

def refusals(mesh):
    """{case: the message of the NotImplementedError it raised, or a note
    that it did not raise; for what runs now, whether it served as one
    device does}."""
    from repro_torch.core.strategies.parallelization import AutoShard
    from repro_torch.nn.module import Ctx
    from repro_torch.launch.mesh import make_test_mesh

    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "did not raise"
        except NotImplementedError as e:
            out[name] = str(e)
        except Exception as e:  # the wrong refusal: the test reports it
            out[name] = f"{type(e).__name__}: {e}"

    def served(name, arch, head_dim):
        """Served under `fsdp_sp` (ROADMAP item 15a-ii): whether the meshed
        entry points give the unmeshed port's logits and tokens."""
        from _torch_family_ranks import serve_entries, side_inputs

        side = side_inputs(arch, SP_TOKENS.shape[0]) if arch != "gemma-2b" else {}
        sp = AutoShard(dict(mesh.shape), train=False, layout="fsdp_sp")
        got = serve_entries(woven(arch, "serve", mesh.shape, head_dim=head_dim, aspects=[sp]),
                            SP_TOKENS, side, mesh)
        want = serve_entries(woven(arch, "serve", {}, head_dim=head_dim), SP_TOKENS, side)
        err = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                  for k in ("prefill", "decode"))
        out[name] = ("served like one device" if err < 1e-4 and got["server"] == want["server"]
                     and got["layout"] == "fsdp_sp" else f"served otherwise: {err}, {got}, {want}")

    served("whisper_fsdp_sp", "whisper-small", None)
    served("internvl_fsdp_sp", "internvl2-1b", None)
    served("fsdp_sp_serving", "gemma-2b", 64)
    attempt("abstract_mesh", lambda: Ctx(mesh=make_test_mesh((2, 2))))
    return out


SP_TOKENS = np.random.default_rng(11).integers(0, 512, (2, 8)).astype(np.int32)


# -- run_on_mesh's hand-back ---------------------------------------------------------

def large_result(mesh):
    """A result of 64 MB: it passes through a file, not the queue's pipe."""
    return {"rank": mesh.rank, "x": torch.full((16, 1 << 20), float(mesh.size))}


def rank_one_raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return torch.zeros(4)
