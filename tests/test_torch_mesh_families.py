"""PyTorch port on a live mesh: the MoE, encoder-decoder and VLM families
under AutoShard's `megatron_tp`.  Four gloo ranks on the CPU
(`run_on_mesh`, one thread each) on (2, 2) run reduced mixtral-8x22b,
grok-1-314b, whisper-small and internvl2-1b through the port's entry points,
each rank on its heads and its block of the MLPs and the experts, and
reduced mixtral-8x22b again with the published size's `embed` rule over
`data` (the `rules` override; whisper-small too, its rule set by hand):
held against the reference on the same numpy inputs and against the port
without a mesh.

(a) fp32 logits against the reference's `apply`, with whisper's frames and
internvl's image prefix; (b) MoE routing: every rank's experts, ranks and
keep mask bit for bit rank 0's, and the reference's routing arithmetic on
the same layer inputs gives the same; the first MoE layer alone gives the
unmeshed output and input gradient with one all-reduce over `model` each
way; (c) one train step against the reference's jitted unmeshed step, the
port's unmeshed step and the reference's step executed by GSPMD under the
same rules on four host devices (one JAX subprocess); (d) greedy tokens of
the meshed server against the unmeshed server: mixtral's ring pool through
`serve_continuous`, whisper's `serve` with frames (its cross caches come
back unwritten, a rank's heads), internvl's with its image prefix; (e)
each rank holds its block of every expert leaf and of its AdamW state.
The families served under `fsdp_sp` (ROADMAP Queue 1 item 15a-ii: each
entry point against the unmeshed port; their training under it is
`test_torch_mesh_families_sp.py`'s, their serving traffic
`test_torch_mesh_serving_sp.py`'s), and rwkv6-3b's fp32 gradient at 8 layers under `dp_fsdp` against the
unmeshed one.  The rank bodies are in `_torch_family_ranks.py`."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_family_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 240
RUNS = sorted(ranks.RUNS)
ARCHS = sorted({arch for arch, _ in ranks.RUNS.values()})
MOE_RUNS = [r for r in RUNS if ranks.RUNS[r][0] in ("mixtral-8x22b", "grok-1-314b")]
REL_TOL = 1e-4  # the bounds of tests/test_torch_mesh_parallel.py
# internvl's K bias (a Qwen2 backbone) has a gradient of zero in exact
# arithmetic (the softmax ignores a shift every key shares): what reaches
# Adam is the rounding of the sum, which sets the sign of its one-step
# update — the exemption `tests/test_torch_mesh_fsdp.py` makes for qwen2-72b
ZERO_GRAD_TOL = {"/blocks0/block/attn/bk": 1e-3}
BATCH = {"vocab": 512, "seq_len": 16, "global_batch": 4}
TOKENS = np.random.default_rng(1).integers(0, 512, (4, 12)).astype(np.int32)


def on_mesh(fn, shape=(2, 2)):
    return run_on_mesh(fn, shape, backend="gloo", device="cpu", threads=1,
                       timeout_s=TIMEOUT_S)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _tree(flat: dict, prefix: str) -> dict:
    """The nested tree of the `prefix/...` keys of a flat npz."""
    out: dict = {}
    for key in flat:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parts, last = key[len(prefix) + 1:].split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = flat[key]
    return out


def _batch(run):
    """The train batch of a run: tokens / labels, and its side inputs."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    batch = next(TokenPipeline(PipelineConfig(**BATCH)))
    return {**batch, **ranks.side_inputs(run, BATCH["global_batch"], seed=6)}


# the reference, in one subprocess of four host devices: each arch's weights
# and logits, its jitted unmeshed train step, and each run's step executed
# by GSPMD under the run's rules on the (2, 2) mesh
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import SHAPES
    from repro.core.program import Program
    from repro.distributed.sharding import input_shardings, param_shardings
    from repro.launch.mesh import make_test_mesh
    from repro.launch.weave import default_weave
    from repro.models.registry import build_model, reduced_config
    from repro.nn.dtypes import PolicyResolver
    from repro.nn.module import Ctx, init_params
    from repro.optim import adamw, schedule
    from repro.runtime.steps import build_train_step

    runs, extra_blocks = {runs!r}, {extra!r}
    inputs = np.load({inputs!r})
    mesh = make_test_mesh((2, 2), ("data", "model"))
    f32 = PolicyResolver.default("f32")
    lr = lambda s: schedule.constant(s, peak={lr!r})
    opt_cfg = adamw.AdamWConfig(eps={eps!r})
    out = {{}}

    def put(prefix, tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(prefix, v, path + "/" + k)
        else:
            out[prefix + path] = np.asarray(tree, np.float32)

    def feed(run, kind):
        keys = [k.split("|", 1)[1] for k in inputs.files if k.startswith(run + "|" + kind)]
        return {{k.split("/", 1)[1]: jnp.asarray(inputs[run + "|" + k]) for k in keys}}

    models, stepped = {{}}, set()
    for run, (arch, embed) in sorted(runs.items()):
        cfg = reduced_config(arch).replace(head_dim=64)
        if arch not in models:
            model = build_model(cfg)
            params = init_params(model, jax.random.PRNGKey(0), f32)
            models[arch] = (model, params)
            put(arch + "|params", params)
            fwd = jax.jit(lambda p, x: model(p, x, ctx=Ctx(policies=f32), mode="dense")[0])
            out[arch + "|logits"] = np.asarray(fwd(params, feed(run, "logits")), np.float32)
        model, params = models[arch]
        batch = feed(run, "batch")

        def woven(axes):
            rules = {{"rules": {{"embed": embed}}}} if embed else {{}}
            w = default_weave(Program(model=model, cfg=cfg, kind="train"),
                              SHAPES["train_4k"], axes,
                              overrides={{"accum_steps": 1, "remat": "full",
                                         "tuned_kernels": False, **rules, **extra_blocks}})
            w.state.policies = f32
            return w

        opt = adamw.init_state(params, adamw.AdamWConfig())
        if arch not in stepped:
            stepped.add(arch)
            step = jax.jit(build_train_step(woven({{}}), lr_fn=lr, opt_cfg=opt_cfg))
            p, _, m = step(params, opt, batch, jnp.asarray(0, jnp.int32))
            put(arch + "|step", p)
            out[arch + "|step_metrics/loss"] = np.asarray(m["loss"])
            out[arch + "|step_metrics/grad_norm"] = np.asarray(m["grad_norm"])
        w = woven(dict(mesh.shape))
        assert w.state.extra["layout"] == "megatron_tp", w.state.extra["layout"]
        ps = param_shardings(model, mesh, w.state.rules)
        repl = NamedSharding(mesh, P())
        ps_opt = {{"master": ps, "m": ps, "v": ps, "count": repl}}
        ps_b = input_shardings(batch, mesh, w.state.rules)
        mstep = jax.jit(build_train_step(w, mesh=mesh, lr_fn=lr, opt_cfg=opt_cfg),
                        in_shardings=(ps, ps_opt, ps_b, repl))
        p, _, m = mstep(jax.device_put(params, ps), jax.device_put(opt, ps_opt),
                        jax.device_put(batch, ps_b), jnp.asarray(0, jnp.int32))
        put(run + "|gspmd", p)
        out[run + "|gspmd_metrics/loss"] = np.asarray(m["loss"])
        out[run + "|gspmd_metrics/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez({out!r}, **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, logits and unmeshed steps by arch, and its
    GSPMD step by run."""
    tmp = tmp_path_factory.mktemp("family_reference")
    arrays = {}
    for run in RUNS:
        for k, v in {"tokens": TOKENS, **ranks.side_inputs(run, TOKENS.shape[0])}.items():
            arrays[f"{run}|logits/{k}"] = v
        for k, v in _batch(run).items():
            arrays[f"{run}|batch/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    script = REFERENCE.format(src=SRC, runs=ranks.RUNS, extra=ranks.EXTRA,
                              inputs=str(tmp / "in.npz"), out=str(tmp / "out.npz"),
                              lr=ranks.LR, eps=ranks.ADAM_EPS)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    flat = dict(np.load(tmp / "out.npz"))
    out = {}
    for r in RUNS:
        arch = ranks.RUNS[r][0]
        out[r] = {key: _tree(flat, f"{arch}|{key}") for key in ("params", "step",
                                                              "step_metrics")}
        out[r].update({key: _tree(flat, f"{r}|{key}") for key in ("gspmd", "gspmd_metrics")})
        out[r]["logits"] = flat[f"{arch}|logits"]
    return out


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's own unmeshed train step of each run from the reference's
    weights."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step

    out = {}
    for run in RUNS:
        w = ranks.woven(run, "train", {}, {"accum_steps": 1, "remat": "full"})
        params = ranks.whole_params(w, reference[run]["params"])
        step = build_train_step(w, lr_fn=lambda s: ranks.schedule.constant(s, peak=ranks.LR),
                                opt_cfg=adamw.AdamWConfig(eps=ranks.ADAM_EPS))
        params, _, m = step(params, adamw.init_state(params, adamw.AdamWConfig()),
                            ranks._tensors(_batch(run)), 0)
        out[run] = {"params": ranks.to_host(params),
                    "metrics": {k: float(v) for k, v in m.items()}}
    return out


@pytest.fixture(scope="module")
def meshed(reference):
    """(a), (b), (c), (e) of every run in one spawn of the (2, 2) mesh."""
    return on_mesh(functools.partial(
        ranks.suite, {r: reference[r]["params"] for r in RUNS}, TOKENS,
        {r: _batch(r) for r in RUNS}))


# -- (a) logits ------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_logits_on_a_2x2_mesh_match_the_reference(meshed, reference, run):
    got = meshed[run]["logits"]
    assert got["layout"] == "megatron_tp"
    embed = ranks.RUNS[run][1]
    assert (tuple(got["rules"]["embed"]) if got["rules"]["embed"] else None) == embed
    np.testing.assert_allclose(got["logits"], reference[run]["logits"], atol=1e-4, rtol=1e-4)


# -- (b) routing --------------------------------------------------------------------

def _reference_route(np_router, x, top_k):
    """The reference's routing arithmetic (`repro/nn/moe.py`) on the grouped
    tokens `x`: fp32 logits, softmax, `lax.top_k`, each (token, k)'s rank
    within its expert as an exclusive cumulative sum."""
    import jax
    import jax.numpy as jnp

    E = np_router.shape[-1]
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(np_router),
                        preferred_element_type=jnp.float32)
    _, tope = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    onehot = jax.nn.one_hot(tope, E, dtype=jnp.float32)
    Bg, Sg = x.shape[:2]
    flat = onehot.reshape(Bg, Sg * top_k, E)
    ranks_ = (jnp.cumsum(flat, axis=1) - flat).reshape(Bg, Sg, top_k, E)
    return np.asarray(tope), np.asarray(jnp.sum(ranks_ * onehot, axis=-1)).astype(np.int64)


@pytest.mark.parametrize("run", MOE_RUNS)
def test_moe_routing_is_identical_on_every_rank_and_the_reference_s(meshed, reference, run):
    """Every rank routes its rows as the other rank of its `model` group
    does, bit for bit, and as the reference's routing arithmetic routes
    the same layer inputs; a rank's rows (the batch over `data`) keep one
    card's groups, capacities and drops."""
    got = meshed[run]["logits"]
    every, coords = got["routing"], got["coords"]
    cfg = ranks.reduced_config(ranks.RUNS[run][0])
    assert len(every) == 4 and all(len(r) == cfg.num_layers for r in every)
    for r, (d, m) in enumerate(coords):
        peer = coords.index((d, 0))
        for mine, first in zip(every[r], every[peer]):
            for key in ("x", "experts", "ranks", "keep"):
                np.testing.assert_array_equal(mine[key], first[key])
    routers = dict(_leaves(reference[run]["params"]))
    stacks = sorted({p.split("/")[1] for p in routers if p.endswith("/ffn/router")})
    per_layer = [r[i] for stack in stacks
                 for i in range(routers[f"/{stack}/block/ffn/router"].shape[0])
                 for r in [routers[f"/{stack}/block/ffn/router"]]]
    C = ranks.moe.capacity(TOKENS.shape[1], cfg.top_k, 1.25, cfg.num_experts)
    for rank in every:
        for call, router in zip(rank, per_layer):
            tope, rk = _reference_route(router, call["x"], cfg.top_k)
            np.testing.assert_array_equal(call["experts"], tope)
            np.testing.assert_array_equal(call["ranks"], rk)
            np.testing.assert_array_equal(call["keep"], rk < C)
            assert call["x"].shape[0] == TOKENS.shape[0] // 2 and call["capacity"] == C


def test_the_moe_layer_sums_its_experts_once_and_the_router_not_at_all(meshed, reference):
    """The first MoE layer alone: the output and the input's gradient equal
    the unmeshed layer's (the router's share of the gradient is whole on
    each rank, the experts' summed over `model` once), one all-reduce over
    `model` in the forward (after `wo`) and one in the backward (`copy_to`
    of the experts' branch)."""
    run = "mixtral-8x22b"
    got = meshed[run]["moe_layer"]
    w = ranks.woven(run, "train", {})
    model = w.program.model
    params = ranks.whole_params(w, reference[run]["params"])
    x = torch.from_numpy(meshed[run]["logits"]["routing"][0][0]["x"][:1]).requires_grad_(True)
    layer = {k: v[0] for k, v in params[model.trunk[0].name]["block"]["ffn"].items()}
    y = model.trunk[0].template.ffn(layer, x, ctx=w.state.make_ctx())
    (dx,) = torch.autograd.grad(torch.sum(y * y), x)
    assert rel_rms(got["y"], y.detach().numpy()) < REL_TOL
    assert rel_rms(got["dx"], dx.numpy()) < REL_TOL
    assert (got["forward"], got["backward"]) == (1, 1)


# -- (c) one train step -------------------------------------------------------------

def _close_step(got, want, got_metrics, want_metrics):
    for key in ("loss", "grad_norm"):
        assert rel_rms(got_metrics[key], want_metrics[key]) < REL_TOL, \
            (key, got_metrics[key], want_metrics[key])
    got = dict(_leaves(got))
    want = dict(_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.shape(got[path]) == np.shape(w), path
        assert rel_rms(got[path], w) < ZERO_GRAD_TOL.get(path, REL_TOL), \
            (path, rel_rms(got[path], w))


@pytest.mark.parametrize("against", ["reference", "unmeshed", "gspmd"])
@pytest.mark.parametrize("run", RUNS)
def test_a_train_step_on_a_2x2_mesh_matches(meshed, reference, unmeshed, run, against):
    got = meshed[run]["train"]
    assert got["layout"] == "megatron_tp"
    if against == "reference":
        want, want_metrics = reference[run]["step"], reference[run]["step_metrics"]
    elif against == "gspmd":
        want, want_metrics = reference[run]["gspmd"], reference[run]["gspmd_metrics"]
    else:
        want, want_metrics = unmeshed[run]["params"], unmeshed[run]["metrics"]
    _close_step(got["params"], want, got["metrics"], want_metrics)


# -- (e) shard sizes and collectives ---------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_each_rank_holds_its_block_of_every_leaf_and_its_adamw_state(meshed, run):
    got = meshed[run]["train"]
    whole = dict(_leaves(got["whole_shapes"]))
    specs = dict(_leaves(got["specs"]))
    extent = {"data": 2, "model": 2}
    for r in got["resident"]:
        for tree in ("params", "master", "m", "v"):
            for path, shape in _leaves(r[tree]):
                want = list(whole[path])
                for dim, entry in enumerate(specs[path]):
                    for a in (entry if isinstance(entry, tuple) else (entry,)):
                        if a:
                            want[dim] //= extent[a]
                assert tuple(shape) == tuple(want), (tree, path, shape, want)
    experts = {p: s for p, s in specs.items() if p.rsplit("/", 1)[-1] in ("wi", "wg", "wo")
               and "/ffn/" in p and len(whole[p]) == 4}
    if ranks.RUNS[run][0] in ("mixtral-8x22b", "grok-1-314b"):
        embed = "data" if ranks.RUNS[run][1] else None
        assert set(experts) and all(
            s == ((None, None, embed, "model") if p.endswith(("wi", "wg"))
                  else (None, None, "model", embed)) for p, s in experts.items()), experts
    assert got["counts"]["all_reduce"]["model"]["calls"] > 0, got["counts"]
    assert got["counts"]["all_reduce"]["data"]["calls"] > 0, got["counts"]


# -- (d) serving ----------------------------------------------------------------------

SERVE_RUNS = ["mixtral-8x22b", "whisper-small", "internvl2-1b"]


@pytest.fixture(scope="module")
def served(reference):
    rng = np.random.default_rng(2)
    requests = {
        # every prompt passes mixtral's reduced window of 16: a ring pool
        "prompts": [rng.integers(0, 512, n).astype(np.int32) for n in (18, 20, 24)],
        "tokens": rng.integers(0, 512, (2, 9)).astype(np.int32),
    }
    params = {r: reference[r]["params"] for r in SERVE_RUNS}
    got = on_mesh(functools.partial(ranks.serving, params, requests))
    want = {r: ranks.serve_one(r, params[r], requests) for r in SERVE_RUNS}
    return got, want


@pytest.mark.parametrize("run", SERVE_RUNS)
def test_greedy_tokens_on_a_2x2_mesh_equal_the_unmeshed_server(served, run):
    got, want = served
    assert got[run]["layout"] == "megatron_tp"
    assert got[run]["tokens"] == want[run]["tokens"]
    if run == "mixtral-8x22b":  # a rank's ring pool holds its KV heads
        assert got[run]["pool"]["page_hbm_bytes"] * 2 == want[run]["pool"]["page_hbm_bytes"]
        assert got[run]["batch"] == want[run]["batch"]
    if run == "whisper-small":
        assert got[run]["cross"] == {"same": True, "unchanged": True, "heads": 1}
        assert want[run]["cross"] == {"same": True, "unchanged": True, "heads": 2}


# -- refusals, and rwkv6-3b at depth -----------------------------------------------------

@pytest.fixture(scope="module")
def apart():
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    batch = next(TokenPipeline(PipelineConfig(**BATCH)))
    got = on_mesh(functools.partial(ranks.apart,
                                    ["mixtral-8x22b", "whisper-small", "internvl2-1b"],
                                    RWKV_LAYERS, batch))
    return got, ranks.rwkv_gradient(RWKV_LAYERS, batch)


@pytest.mark.parametrize("run", ["mixtral-8x22b", "whisper-small", "internvl2-1b"])
def test_the_families_serving_under_fsdp_sp_wait_for_15a_ii(apart, run):
    """Served under `fsdp_sp` since ROADMAP item 15a-ii (the name is the
    refusal this test checked before): the meshed prefill and decode logits
    and the server's tokens are the unmeshed port's."""
    got = apart[0]["fsdp_sp"][f"{run}/serve"]
    want = ranks.serve_entries(ranks.fsdp_sp_woven(run, {}), ranks.FSDP_SP_TOKENS,
                               ranks.side_inputs(run, ranks.FSDP_SP_TOKENS.shape[0]))
    assert got["layout"] == "fsdp_sp"
    assert rel_rms(got["prefill"], want["prefill"]) < REL_TOL
    assert rel_rms(got["decode"], want["decode"]) < REL_TOL
    assert got["server"] == want["server"]


RWKV_LAYERS = 8


def test_rwkv6_gradient_at_8_layers_under_dp_fsdp_matches_the_unmeshed_one(apart):
    """The fp32 gradient of reduced rwkv6-3b at 8 layers under `dp_fsdp` on
    (2, 2) (the batch over both axes, every block FSDP over both) against
    the unmeshed one, leaf by leaf: what separates bf16 rounding from a
    fault in the gathers or the gradient mean at depth."""
    got, want = apart[0]["rwkv"], apart[1]
    assert got["layout"] == "dp_fsdp" and tuple(got["rules"]["embed"]) == ("data", "model")
    assert rel_rms(got["loss"], want["loss"]) < REL_TOL
    g, w = dict(_leaves(got["grads"])), dict(_leaves(want["grads"]))
    assert set(g) == set(w)
    flat_g = np.concatenate([g[p].ravel() for p in sorted(w)])
    flat_w = np.concatenate([w[p].ravel() for p in sorted(w)])
    assert rel_rms(flat_g, flat_w) < REL_TOL
    for path in w:
        assert rel_rms(g[path], w[path]) < REL_TOL, (path, rel_rms(g[path], w[path]))


def test_local_draws_give_each_rank_its_block_alone(apart):
    """`init_params(..., local=True)` (a model one card cannot hold, drawn a
    block a rank): each leaf at its block's shape; ranks holding one block
    (a replicated leaf, or a block over `model` on both `data` rows) draw
    the same values, ranks holding two blocks of one leaf other values
    (but where the init is a constant); a scaled leaf's spread is the
    whole leaf's, 1 / sqrt(fan-in)."""
    from repro_torch.nn.module import init_params

    every = apart[0]["local_draws"]
    w = ranks.woven("mixtral-8x22b", "serve", {})
    whole = {p: v.shape for p, v in _leaves(init_params(w.program.model, 0, device="cpu"))}
    leaves = [dict(_leaves(r["params"])) for r in every]
    coords = [dict(_leaves(r["coords"])) for r in every]
    assert set(leaves[0]) == set(whole)
    split = 0
    for path, shape in whole.items():
        blocks = [len({c[path][d] if d < len(c[path]) else 0 for c in coords})
                  for d in range(len(shape))]
        assert tuple(n * b for n, b in zip(leaves[0][path].shape, blocks)) == shape, path
        split += max(blocks) > 1
        constant = np.all(leaves[0][path] == leaves[0][path].flat[0])
        for a in range(4):
            for b in range(a + 1, 4):
                same = coords[a][path] == coords[b][path]
                equal = np.array_equal(leaves[a][path], leaves[b][path])
                assert equal == same or constant, (path, a, b)
    assert split > 0
    wi = np.concatenate([r["/blocks0/block/ffn/wi"].ravel() for r in leaves])
    assert abs(wi.std() * np.sqrt(ranks.reduced_config("mixtral-8x22b").d_model) - 1) < 0.05
