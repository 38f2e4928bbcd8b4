"""Rank bodies of `tests/test_torch_mesh_serving_sp.py`.  `run_on_mesh`
spawns each rank and imports this module there, so it imports the port and
torch only; every function takes the rank's live mesh last and returns host
values (rank 0's reach the test)."""

import numpy as np
import torch

from _torch_family_ranks import RouteSpy, every_rank
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.core.strategies.parallelization import AutoShard
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import local_shard, param_shardings, tree_shards
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import build_server
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import init_params
from repro_torch.runtime.pages import PagedCacheManager
from repro_torch.runtime.server import Server, ServerConfig

SERVE = {"max_cache_len": 64, "decode_tokens": 5, "page_size": 8}
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16}
# each run: its arch, its mesh, whether `fsdp_sp` is forced through
# AutoShard's `layout=` (else AutoShard picks it), the config's changes
# beyond head_dim 64, and its frames or image tokens
RUNS = {
    "gemma-2b": ("gemma-2b", (2, 2), True, {}, 0),
    "yi-6b": ("yi-6b", (1, 4), True, {}, 0),
    # its window of 16: the continuous prompts pass it (a ring pool), the
    # batch's prompts too (ring caches)
    "mixtral-8x22b": ("mixtral-8x22b", (2, 2), True, {}, 0),
    "mixtral-8x22b@1x4": ("mixtral-8x22b", (1, 4), True, {}, 0),
    "whisper-small": ("whisper-small", (2, 2), True, {}, 16),
    # 15 frames: no axis divides them, the cross caches stay whole
    "whisper-small+odd": ("whisper-small", (1, 4), True, {}, 15),
    "internvl2-1b": ("internvl2-1b", (2, 2), True, {}, 8),
    # 6 heads on a 4-way `model` axis: AutoShard picks fsdp_sp by itself
    "internvl2-1b@1x4": ("internvl2-1b", (1, 4), False, {"n_heads": 6}, 8),
}
TEXT = ("gemma-2b", "yi-6b", "mixtral-8x22b", "mixtral-8x22b@1x4", "internvl2-1b",
        "internvl2-1b@1x4")
QUANT = ("gemma-2b", "yi-6b")


def config(run):
    arch, _, _, changes, _ = RUNS[run]
    return reduced_config(arch).replace(**{"head_dim": 64, **changes})


def woven(run, mesh_axes):
    """The run's reduced arch, fp32, the attention woven to the kernels
    (their plain versions run on the CPU), laid out on `mesh_axes`
    (unmeshed: `{}`)."""
    cfg = config(run)
    program = Program(model=build_model(cfg), cfg=cfg, kind="serve", device="cpu")
    aspects = [KernelAspect("*", "attention", "cuda")]
    if RUNS[run][2] and mesh_axes:
        aspects = [AutoShard(dict(mesh_axes), train=False, layout="fsdp_sp")] + aspects
    w = default_weave(program, SHAPES["prefill_32k"], dict(mesh_axes),
                      overrides={"tuned_kernels": False, **EXTRA}, extra_aspects=aspects)
    w.state.policies = PolicyResolver.default("f32")
    return w


def params_of(w, np_params, mesh):
    """The reference's weights: whole, or this rank's blocks of them."""
    init_params(w.program.model, 0, w.state.policies, "cpu")
    params = load_jax_params(w.program.model, np_params)
    if mesh is None:
        return params
    return tree_shards(params, param_shardings(w.program.model, mesh, w.state.rules),
                       local_shard)


def side_inputs(run, rows, seed=5):
    """An encoder-decoder's frames or a VLM's image prefix, from a seed."""
    cfg = config(run)
    n = RUNS[run][4]
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((rows, n, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        return {"frames": x}
    if cfg.family == "vlm":
        return {"embeds": (0.04 * x).astype(np.float32)}
    return {}


class PoolSpy:
    """Every page pool a manager makes (its shape), the first admissions'
    first logits, and the pools' codes and scales when the first request
    retires (afterwards its scales go back to the 0.0 sentinel)."""

    def __init__(self):
        self.shapes, self.first, self.snapshot = [], [], None
        self._ensure, self._retire = PagedCacheManager._ensure_pools, PagedCacheManager.retire
        self._first = Server._first_token

    def __enter__(self):
        spy = self

        def ensure(manager, num_pages):
            spy._ensure(manager, num_pages)
            for name, pools in manager._pools.items():
                spy.shapes.append((name, tuple(pools["pk"].shape)))

        def retire(manager, rid):
            if spy.snapshot is None:
                spy.snapshot = {f"{name}/{key}": t.detach().clone().view(torch.int8).numpy()
                                if t.dtype == torch.int8 else t.detach().clone().numpy()
                                for name, pools in manager._pools.items()
                                for key, t in pools.items()}
            return spy._retire(manager, rid)

        def first(server, manager, rid, logits, fault=None):
            spy.first.append(logits[0, -1].detach().float().numpy())
            return spy._first(server, manager, rid, logits, fault)

        PagedCacheManager._ensure_pools = ensure
        PagedCacheManager.retire = retire
        Server._first_token = first
        return self

    def __exit__(self, *exc):
        PagedCacheManager._ensure_pools = self._ensure
        PagedCacheManager.retire = self._retire
        Server._first_token = self._first


def _server(run, np_params, mesh, **cfg):
    w = woven(run, mesh.shape if mesh is not None else {})
    return Server(w, ServerConfig(**SERVE, **cfg), params=params_of(w, np_params, mesh),
                  mesh=mesh, device="cpu")


def prefill_decode(srv, run, tokens):
    """One prefill of `tokens` (with the run's side inputs) and one decode
    step: both logits, the self (and cross) caches' leaf shapes, and on a
    mesh whether the cross caches came back unwritten."""
    toks = torch.from_numpy(tokens).to(torch.int32)
    feed = {"tokens": toks, **{k: torch.from_numpy(v)
                               for k, v in side_inputs(run, toks.shape[0]).items()}}
    logits, cache = srv.prefill_vc(srv._begin(), srv.params, feed)
    pos = toks.shape[1] + (feed["embeds"].shape[1] if "embeds" in feed else 0)
    cross = cache["decoder"]["cross"] if "decoder" in cache else None
    before = {k: v.clone() for k, v in cross.items()} if cross else None
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    step, cache = srv.decode_vc(None, srv.params, {
        "tokens": tok, "positions": torch.full_like(tok, pos)}, cache)
    out = {"prefill": logits[:, -1].float().numpy(), "decode": step[:, -1].float().numpy()}
    group = cache["decoder"]["self"] if "decoder" in cache else cache["blocks0"]
    out["self_k"] = tuple(group["k"].shape)
    if cross:
        out["cross_k"] = tuple(cross["ck"].shape)
        out["cross_unwritten"] = all(torch.equal(cache["decoder"]["cross"][k], before[k])
                                     for k in cross)
    return out


def serve_run(run, np_params, requests, mesh=None):
    """The run's served results (on `mesh`, or unmeshed): greedy tokens of
    every entry point its family serves, the pools each made, one prefill
    and decode's logits and cache shapes, the MoE layers' routing on the
    first prefill, and the collectives this rank counted."""
    collectives.reset_counts()
    srv = _server(run, np_params, mesh)
    cfg = srv.woven.program.cfg
    out = {"layout": srv.woven.state.extra.get("layout")}
    with RouteSpy() as spy:
        out["steps"] = prefill_decode(srv, run, requests["tokens"])
    out["routing"] = [{k: c[k] for k in ("experts", "ranks", "keep")} for c in spy.calls]
    side = side_inputs(run, requests["tokens"].shape[0])
    out["serve"] = srv.serve(requests["tokens"], inputs=side).tolist()
    if side:  # an odd prompt too: the axis divides neither 11 + P nor 11
        out["serve_odd"] = srv.serve(requests["tokens"][:, :11], inputs=side).tolist()
    if run in TEXT:
        batch = requests["moe_batch" if cfg.family == "moe" else "batch"]
        out["batch"] = [b.tolist() for b in srv.serve_batch(batch)]
        prompts = requests["continuous"]
        with PoolSpy() as pools:
            # the pool's invariants audited at every retire, on a rank's slices
            out["continuous"] = [b.tolist() for b in
                                 srv.serve_continuous(prompts, pool_audit=True)]
            out["stats"] = dict(srv.last_pool_stats)
            out["chunked"] = [b.tolist() for b in
                              srv.serve_continuous(prompts, prefill_chunk=8)]
            out["speculative"] = [b.tolist() for b in
                                  srv.serve_continuous(prompts, draft_len=2)]
            out["spec_stats"] = dict(srv.last_spec_stats or {})
        out["pools"] = pools.shapes
    if run in QUANT:
        srv8 = _server(run, np_params, mesh, cache_dtype="int8")
        with PoolSpy() as pools:
            out["int8"] = [b.tolist() for b in srv8.serve_continuous(requests["continuous"])]
        out["int8_pool"] = {"shapes": pools.shapes, "first": pools.first,
                            "snapshot": pools.snapshot}
    out["counts"] = collectives.counts()
    return out


_MESHES = {}  # this rank's meshes of other shapes, by shape


def mesh_of(shape, mesh):
    """A mesh of `shape` over the ranks of `mesh`: made once per shape, by
    every rank in the same order."""
    if shape == mesh.axis_sizes:
        return mesh
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, backend=mesh.backend, device="cpu")
    return _MESHES[shape]


def mesh_for(run, mesh):
    """The run's mesh over the ranks of `mesh`."""
    return mesh_of(RUNS[run][1], mesh)


ENTRY_ARCH, ENTRY_MESH = "gemma-2b", (1, 4)


def entry_point_run(requests, mesh=None):
    """The launchers' entry point, `launch/serve.build_server(...,
    layout="fsdp_sp")`, on `mesh` (None: no mesh and no forced layout):
    reduced gemma-2b as the launchers build it (bf16, random weights from
    the server's seed), its layout and rules, the pools a continuous serve
    made, each admission's first logits and the greedy tokens of
    `serve_continuous` and `serve`."""
    srv = build_server(ENTRY_ARCH, reduced=True, device="cpu", cfg=ServerConfig(**SERVE),
                       mesh=mesh, layout="fsdp_sp" if mesh is not None else None)
    out = {"layout": srv.woven.state.extra.get("layout"),
           "kv_seq": srv.woven.state.rules.get("kv_seq")}
    with PoolSpy() as pools:
        out["continuous"] = [b.tolist() for b in srv.serve_continuous(requests["continuous"])]
    out["pools"], out["first"] = pools.shapes, pools.first
    out["serve"] = srv.serve(requests["tokens"]).tolist()
    return out


def served(np_by_run, requests, mesh):
    """Every run on its mesh, in one spawn: each rank's results, on every
    rank (the (1, 4) meshes are made inside the (2, 2) world), and the
    entry point's under `ENTRY_MESH`'s key."""
    meshes = {run: mesh_for(run, mesh) for run in np_by_run}
    out = {run: every_rank(serve_run(run, np_params, requests, meshes[run]), mesh)
           for run, np_params in np_by_run.items()}
    out["build_server"] = every_rank(entry_point_run(requests, mesh_of(ENTRY_MESH, mesh)), mesh)
    return out
