"""Rank bodies of `tests/test_torch_mesh_quantized.py`.  `run_on_mesh` spawns
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
from repro_torch.core.strategies.parallelization import CompressionAspect
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    NamedSharding,
    gather_shards,
    input_shardings,
    local_shard,
    param_shardings,
    tree_shards,
)
from repro_torch.kernels.flash_attention.ops import local_kv_heads
from repro_torch.launch.weave import default_weave
from repro_torch.models.lm import whole_logits
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import DTypePolicy, PolicyResolver
from repro_torch.nn.module import init_params
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.pages import PagedCacheManager

ADAM_EPS = 1e-6
LR = 1e-3
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16}
SERVE = {"max_cache_len": 40, "decode_tokens": 5, "page_size": 8}
# the compressed train step's model: one layer, so that a K / V bias of
# 128 elements (2 KV heads x 64) is split over `model` into blocks of 64
TRAIN_ARCH = ("qwen2-72b", {"num_layers": 1})


def woven(arch, kind, mesh_axes, *, policy="f32", replace=None, aspects=()):
    """Reduced `arch` at head_dim 64 (the kernels' plain versions run),
    `replace` changing more of its fields, under `policy`, the attention
    woven to the kernels, the layout AutoShard picks for `mesh_axes`."""
    cfg = reduced_config(arch).replace(head_dim=64, **(replace or {}))
    program = Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cpu")
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    overrides = {"tuned_kernels": False, **EXTRA}
    if kind == "train":
        overrides.update(accum_steps=1, remat="full")
    w = default_weave(program, shape, dict(mesh_axes), overrides=overrides,
                      extra_aspects=[*aspects, KernelAspect("*", "attention", "cuda")])
    w.state.policies = PolicyResolver.default(policy)
    return w


def whole_params(w, np_params):
    """The one-device param tree of `w`'s model, from the reference's."""
    init_params(w.program.model, 0, w.state.policies, "cpu")
    return load_jax_params(w.program.model, np_params)


def rank_params(w, np_params, mesh):
    """This rank's blocks of the reference's weights."""
    return tree_shards(whole_params(w, np_params),
                       param_shardings(w.program.model, mesh, w.state.rules), local_shard)


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().float().numpy()


def every_rank(obj, mesh) -> list:
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def kv_heads_of(cfg, mesh) -> list:
    """The one-device KV heads this rank's pool holds (its q heads')."""
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    h_loc = cfg.n_heads // tp
    coord = mesh.coord("model") if mesh is not None else 0
    return local_kv_heads(cfg.n_heads, cfg.kv_heads, coord * h_loc, h_loc)


class ScaleSnapshot:
    """The pool's scale sidecars as they stand when the first request
    retires (afterwards its pages go back to the 0.0 sentinel)."""

    def __init__(self):
        self.scales = None
        self._real = PagedCacheManager.retire

    def __enter__(self):
        snap = self

        def retire(manager, rid):
            if snap.scales is None:
                snap.scales = {f"{name}/{key}": pools[key].detach().clone().numpy()
                               for name, pools in manager._pools.items()
                               for key in ("ksc", "vsc") if key in pools}
            return snap._real(manager, rid)

        PagedCacheManager.retire = retire
        return self

    def __exit__(self, *exc):
        PagedCacheManager.retire = self._real


def pool_serve(arch, np_params, prompts, cache_dtype, mesh=None):
    """`serve_continuous` over an int8 / fp8 pool: the tokens, the pool's
    stats, the sidecars at the first retire and the heads they hold (the
    server without a mesh where `mesh` is None)."""
    from repro_torch.runtime.server import Server, ServerConfig

    w = woven(arch, "serve", mesh.shape if mesh is not None else {})
    params = rank_params(w, np_params, mesh) if mesh is not None else \
        whole_params(w, np_params)
    srv = Server(w, ServerConfig(**SERVE, cache_dtype=cache_dtype), mesh=mesh,
                 device="cpu", params=params)
    with ScaleSnapshot() as snap:
        out = srv.serve_continuous(prompts)
    return {"tokens": [list(map(int, o)) for o in out], "stats": srv.last_pool_stats,
            "scales": snap.scales, "heads": kv_heads_of(w.program.cfg, mesh),
            "outcomes": [o["status"] for o in srv.last_outcomes]}


def pools(cases, np_params, prompts, mesh):
    """(a): every (arch, cache dtype) of `cases` served on this rank;
    each rank's result, on every rank."""
    return {case: every_rank(pool_serve(case[0], np_params[case[0]], prompts, case[1],
                                        mesh), mesh)
            for case in cases}


# -- (b) int8 weights on a row-parallel product -------------------------------------


def row_linear(w_np, x_np, mesh):
    """A row-parallel `fixed` Linear's rows on this rank: its codes and
    scales (`_quantize_int8` over the mesh), the fp32 product summed over
    `model` (`_int8_matmul`) and `Linear.forward`'s output, with the
    `max` all-reduces counted."""
    from repro_torch.nn.blocks import Linear, _int8_matmul, _quantize_int8
    from repro_torch.nn.module import Ctx

    tp, me = mesh.shape["model"], mesh.coord("model")
    n = w_np.shape[0] // tp
    w = torch.from_numpy(w_np)[me * n:(me + 1) * n]
    x = torch.from_numpy(x_np)[..., me * n:(me + 1) * n]
    policy = DTypePolicy.make("fixed")
    collectives.reset_counts()
    q, scale = _quantize_int8(w, mesh)
    y32 = _int8_matmul(x.to(policy.compute_dtype), q, scale, policy, mesh)
    ctx = Ctx(policies=PolicyResolver.default("fixed"), mesh=mesh)
    lin = Linear("wo", w_np.shape[0], w_np.shape[1], axes=("mlp", "embed"))
    y = lin({"w": w}, x, ctx=ctx)
    got = {"q": q.numpy(), "scale": scale.numpy(), "y32": y32.numpy(),
           "y": y.float().numpy(), "rows": (me * n, (me + 1) * n),
           "counts": collectives.counts()}
    return every_rank(got, mesh)


def fixed_logits(arch, np_params, tokens, mesh):
    """(b): `arch`'s logits under the `fixed` policy (int8 MLP weights) on
    this rank's blocks, the batch's rows gathered."""
    w = woven(arch, "serve", mesh.shape, policy="fixed")
    model, rules = w.program.model, w.state.rules
    toks = torch.from_numpy(tokens)
    toks = local_shard(toks, input_shardings({"tokens": toks}, mesh, rules)["tokens"])
    with torch.no_grad():
        out, _ = model(rank_params(w, np_params, mesh), {"tokens": toks},
                       ctx=w.state.make_ctx(mesh=mesh), mode="dense")
    out = collectives.all_gather(whole_logits(out, mesh, w.program.cfg.vocab),
                                 mesh, "data", 0)
    return out.float().numpy()


# -- (c) int8 gradient compression --------------------------------------------------


def compress_leaves(leaves_np, specs, mesh):
    """`ef_compress` of each whole leaf's block on this rank, the leaf split
    by its spec: the dequantized block and the residual, gathered whole,
    with whether it was compressed (a residual that is not all zero)."""
    from repro_torch.optim.compression import ef_compress

    out = []
    for g_np, spec in zip(leaves_np, specs):
        sh = NamedSharding(mesh, spec)
        g = local_shard(torch.from_numpy(g_np), sh)
        numel = g.numel() * int(np.prod([mesh.shape[a] for a in sh.axes()]))
        deq, ef = ef_compress(g, torch.zeros_like(g), mesh=mesh,
                              row_axes=sh.dim_axes(-1), numel=numel)
        out.append((gather_shards(deq, sh).numpy(), gather_shards(ef, sh).numpy(),
                    tuple(g.shape)))
    return out


def compressed_step(np_params, batch, mesh):
    """(c): one compressed train step of `TRAIN_ARCH` on this rank: the
    metrics, the params and `ef` gathered whole, the shape of each of this
    rank's `ef` blocks, the collectives counted."""
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime.steps import build_train_step

    arch, replace = TRAIN_ARCH
    w = woven(arch, "train", mesh.shape, replace=replace)
    shardings = param_shardings(w.program.model, mesh, w.state.rules)
    params = rank_params(w, np_params, mesh)
    opt_cfg = adamw.AdamWConfig(eps=ADAM_EPS, compression=True)
    opt = adamw.init_state(params, opt_cfg)
    step = build_train_step(w, mesh=mesh, opt_cfg=opt_cfg,
                            lr_fn=lambda s: schedule.constant(s, peak=LR))
    collectives.reset_counts()
    params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    ef_shapes = every_rank([tuple(e.shape) for e in leaves(opt["ef"])], mesh)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": to_host(tree_shards(params, shardings, gather_shards)),
            "ef": to_host(tree_shards(opt["ef"], shardings, gather_shards)),
            "ef_shapes": ef_shapes,
            "param_shapes": [tuple(p.shape) for p in leaves(params)],
            "counts": collectives.counts()}


def compressed_trainer(ckpt_dir, mesh):
    """A meshed `Trainer` of `TRAIN_ARCH` under `CompressionAspect`: two
    steps and a checkpoint of the whole state, `ef` included, written by
    rank 0.  Returns rank 0's whole params and `ef`."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    arch, replace = TRAIN_ARCH
    w = woven(arch, "train", mesh.shape, replace=replace, aspects=[CompressionAspect()])
    trainer = Trainer(w, TokenPipeline(PipelineConfig(vocab=512, seq_len=16,
                                                      global_batch=4)),
                      TrainerConfig(steps=2, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0),
                      mesh=mesh)
    trainer.run(2)  # its checkpoint at step 2 is on disk when it returns
    ps, opt_sh = trainer._shardings()
    return {"compression": trainer.opt_cfg.compression,
            "params": to_host(tree_shards(trainer.params, ps, gather_shards)),
            "ef": to_host(tree_shards(trainer.opt_state["ef"], opt_sh["ef"], gather_shards))}


# -- (d) speculative decoding and the verify step --------------------------------


def speculative(np_params, prompts, fed, mesh):
    """(d): reduced yi-6b on this rank, fp32: plain and self-drafted (k = 2)
    `serve_continuous` over the fp and the int8 pool, the steps and spec
    stats; one verify step's whole logits over each pool; a draft off this
    mesh refused."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.server import Server, ServerConfig

    w = woven("yi-6b", "serve", mesh.shape)
    srv = Server(w, ServerConfig(**SERVE), mesh=mesh, device="cpu",
                 params=rank_params(w, np_params, mesh))
    out = {}
    for dt in (None, "int8"):
        srv.cfg.cache_dtype = dt
        for k in (0, 2):
            toks = srv.serve_continuous(prompts, draft_len=k)
            out[dt, k] = {"tokens": [list(map(int, o)) for o in toks],
                          "steps": dict(srv.last_step_counts),
                          "spec": srv.last_spec_stats,
                          "outcomes": [o["status"] for o in srv.last_outcomes]}
        out[dt, "verify"] = verify_logits(srv, prompts, fed)
    srv.cfg.cache_dtype = None
    refused = {}
    other = make_mesh((2, 1), backend=mesh.backend, device="cpu")
    for name, draft in (("no_mesh", Server(woven("yi-6b", "serve", {}),
                                          ServerConfig(**SERVE), device="cpu")),
                        ("other_mesh", Server(woven("yi-6b", "serve", other.shape),
                                              ServerConfig(**SERVE), mesh=other,
                                              device="cpu"))):
        try:
            srv.serve_continuous(prompts, draft_len=2, draft=draft)
            refused[name] = "did not raise"
        except ValueError as e:
            refused[name] = f"ValueError: {e}"
    out["refused"] = refused
    return out


def verify_logits(srv, prompts, fed):
    """One verify step (S = 3) over a paged pool of `srv`'s cache dtype
    holding `prompts`: its logits (whole on a mesh)."""
    srv._begin()
    ps, max_len = SERVE["page_size"], SERVE["max_cache_len"]
    manager = PagedCacheManager(16, ps, max_len=max_len, cache_dtype=srv.cfg.cache_dtype)
    for r, p in enumerate(prompts):
        srv._paged_admit(manager, r, p, max_len - 4, None)
    pos = (np.array([len(p) for p in prompts])[:, None] + np.arange(3)).astype(np.int32)
    logits, _ = srv._verify_step(None, 2)(
        srv.params, {"tokens": torch.from_numpy(fed), "positions": torch.from_numpy(pos)},
        manager.batch(list(range(len(prompts))), tokens=3))
    return logits.numpy()
