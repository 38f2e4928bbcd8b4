"""PyTorch port on a live mesh under the FSDP layouts: four gloo ranks on the
CPU (`run_on_mesh`, one thread each) on (2, 2) run AutoShard's layouts
through the port's entry points, each rank on its shard, held against the
reference on the same numpy inputs and against the port without a mesh.

The four runs: reduced rwkv6-3b and recurrentgemma-2b under `dp_fsdp`
(batch rows over `(data, model)`), reduced gemma-2b under `fsdp_sp` (its
pod layout: the sequence over `model`, the vocab over `model`), and reduced
qwen2-72b under `megatron_tp` with `embed` over `data`; every weight's
`embed` dim split as the published size's rule splits it.

(a) fp32 logits against the reference's `apply`; (b) one train step
against the reference's jitted unmeshed step and the port's unmeshed step,
and (b') for `dp_fsdp` and `fsdp_sp` against the reference's step executed
under the same rules on four host devices (GSPMD's own answer; the
reference runs in one subprocess); (c) each rank holds its block of every
FSDP leaf and of its AdamW state; (d) greedy `serve_batch` / `serve`
tokens of the recurrent pair; (e) a meshed FSDP trainer's whole checkpoint
and `reshard_params` under FSDP rules, bit for bit; (f) the FSDP gathers
are counted as their own kind and no FSDP leaf's gradient is reduced a
second time; gemma-2b served under `fsdp_sp` as the unmeshed port serves
it.  The rank bodies are in
`_torch_fsdp_ranks.py`."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_fsdp_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 240
ARCHS = sorted(ranks.LAYOUTS)
FSDP_ARCHS = [a for a in ARCHS if ranks.LAYOUTS[a][0] != "megatron_tp"]
RECURRENT = ["recurrentgemma-2b", "rwkv6-3b"]
REL_TOL = 1e-4  # the bounds of tests/test_torch_mesh_parallel.py
BATCH = {"vocab": 512, "seq_len": 16, "global_batch": 4}
# qwen2's K bias has a gradient of zero in exact arithmetic (the softmax
# ignores a shift every key shares): what reaches Adam is the rounding of
# the sum, which sets the sign of its one-step update, so two exact-to-fp32
# computations of it agree to 1e-4 of their RMS only by chance
ZERO_GRAD_TOL = {"/blocks0/block/attn/bk": 1e-3}


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


def _batch():
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    return next(TokenPipeline(PipelineConfig(**BATCH)))


TOKENS = np.random.default_rng(1).integers(0, 512, (4, 12)).astype(np.int32)

# the reference, in one subprocess of four host devices: every arch's
# weights and logits, its jitted unmeshed train step, and (FSDP layouts)
# the same step executed under the same rules on the (2, 2) mesh
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import SHAPES
    from repro.core.program import Program
    from repro.core.strategies.parallelization import AutoShard, ShardingAspect
    from repro.distributed.sharding import input_shardings, param_shardings
    from repro.launch.mesh import make_test_mesh
    from repro.launch.weave import default_weave
    from repro.models.registry import build_model, reduced_config
    from repro.nn.dtypes import PolicyResolver
    from repro.nn.module import Ctx, init_params
    from repro.optim import adamw, schedule

    from repro.runtime.steps import build_train_step

    layouts, extra_blocks = {layouts!r}, {extra!r}
    inputs = np.load({inputs!r})
    tokens = jnp.asarray(inputs["logit_tokens"])
    batch = {{k: jnp.asarray(inputs[k]) for k in ("tokens", "labels")}}
    mesh = make_test_mesh((2, 2), ("data", "model"))
    f32 = PolicyResolver.default("f32")
    out = {{}}

    def put(prefix, tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(prefix, v, path + "/" + k)
        else:
            out[prefix + path] = np.asarray(tree, np.float32)

    for arch, (layout, embed) in layouts.items():
        cfg = reduced_config(arch).replace(head_dim=64)
        model = build_model(cfg)
        params = init_params(model, jax.random.PRNGKey(0), f32)
        put(arch + "|params", params)
        fwd = jax.jit(lambda p, t: model(p, {{"tokens": t}}, ctx=Ctx(policies=f32),
                                         mode="dense")[0])
        out[arch + "|logits"] = np.asarray(fwd(params, tokens), np.float32)

        def woven(axes):
            extra = None
            if layout == "fsdp_sp":
                extra = [AutoShard(axes, train=True, layout=layout),
                         ShardingAspect({{"embed": embed}})]
            w = default_weave(Program(model=model, cfg=cfg, kind="train"),
                              SHAPES["train_4k"], axes,
                              overrides={{"accum_steps": 1, "remat": "full",
                                         "tuned_kernels": False,
                                         "rules": {{"embed": embed}}, **extra_blocks}},
                              extra_aspects=extra)
            w.state.policies = f32
            return w

        lr = lambda s: schedule.constant(s, peak={lr!r})
        opt_cfg = adamw.AdamWConfig(eps={eps!r})
        opt = adamw.init_state(params, adamw.AdamWConfig())
        step = jax.jit(build_train_step(woven({{}}), lr_fn=lr, opt_cfg=opt_cfg))
        p, _, m = step(params, opt, batch, jnp.asarray(0, jnp.int32))
        put(arch + "|step", p)
        out[arch + "|step_metrics/loss"] = np.asarray(m["loss"])
        out[arch + "|step_metrics/grad_norm"] = np.asarray(m["grad_norm"])
        if layout == "megatron_tp":
            continue
        w = woven(dict(mesh.shape))
        assert w.state.extra["layout"] == layout, w.state.extra["layout"]
        ps = param_shardings(model, mesh, w.state.rules)
        repl = NamedSharding(mesh, P())
        ps_opt = {{"master": ps, "m": ps, "v": ps, "count": repl}}
        ps_b = input_shardings(batch, mesh, w.state.rules)
        mstep = jax.jit(build_train_step(w, mesh=mesh, lr_fn=lr, opt_cfg=opt_cfg),
                        in_shardings=(ps, ps_opt, ps_b, repl))
        p, _, m = mstep(jax.device_put(params, ps), jax.device_put(opt, ps_opt),
                        jax.device_put(batch, ps_b), jnp.asarray(0, jnp.int32))
        put(arch + "|gspmd", p)
        out[arch + "|gspmd_metrics/loss"] = np.asarray(m["loss"])
        out[arch + "|gspmd_metrics/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez({out!r}, **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, logits, unmeshed and GSPMD steps, by arch."""
    tmp = tmp_path_factory.mktemp("fsdp_reference")
    np.savez(tmp / "in.npz", logit_tokens=TOKENS, **_batch())
    script = REFERENCE.format(src=SRC, layouts=ranks.LAYOUTS, extra=ranks.EXTRA,
                              inputs=str(tmp / "in.npz"), out=str(tmp / "out.npz"),
                              lr=ranks.LR, eps=ranks.ADAM_EPS)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    flat = dict(np.load(tmp / "out.npz"))
    out = {}
    for arch in ARCHS:
        out[arch] = {key: _tree(flat, f"{arch}|{key}")
                     for key in ("params", "step", "gspmd", "step_metrics",
                                 "gspmd_metrics")}
        out[arch]["logits"] = flat[f"{arch}|logits"]
    return out


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's own unmeshed train step of each arch from the reference's
    weights."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step

    out = {}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for arch in ARCHS:
        w = ranks.woven(arch, "train", {}, {"accum_steps": 1, "remat": "full"})
        params = ranks.whole_params(w, reference[arch]["params"])
        step = build_train_step(w, lr_fn=lambda s: ranks.schedule.constant(s, peak=ranks.LR),
                                opt_cfg=adamw.AdamWConfig(eps=ranks.ADAM_EPS))
        params, _, m = step(params, adamw.init_state(params, adamw.AdamWConfig()), batch, 0)
        out[arch] = {"params": ranks.to_host(params),
                     "metrics": {k: float(v) for k, v in m.items()}}
    return out


@pytest.fixture(scope="module")
def meshed(reference):
    """(a), (b), (c), (f) of every arch in one spawn of the (2, 2) mesh."""
    return on_mesh(functools.partial(
        ranks.suite, {a: reference[a]["params"] for a in ARCHS}, TOKENS, [_batch()]))


# -- (a) logits ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_logits_on_a_2x2_fsdp_mesh_match_the_reference(meshed, reference, arch):
    run = meshed[arch]
    layout, embed = ranks.LAYOUTS[arch]
    assert run["logits_layout"] == layout
    assert tuple(run["logits_rules"]["embed"]) == embed
    np.testing.assert_allclose(run["logits"], reference[arch]["logits"],
                               atol=1e-4, rtol=1e-4)


# -- (b) one train step -------------------------------------------------------------

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


@pytest.mark.parametrize("against", ["reference", "unmeshed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_train_step_on_a_2x2_fsdp_mesh_matches(meshed, reference, unmeshed, arch,
                                                  against):
    run = meshed[arch]["train"]
    assert run["layout"] == ranks.LAYOUTS[arch][0]
    if against == "reference":
        want, want_metrics = reference[arch]["step"], reference[arch]["step_metrics"]
    else:
        want, want_metrics = unmeshed[arch]["params"], unmeshed[arch]["metrics"]
    _close_step(run["params"], want, run["metrics"][0], want_metrics)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_a_train_step_on_a_2x2_fsdp_mesh_matches_gspmd(meshed, reference, arch):
    """The reference's step executed under the same rules on four host
    devices: what GSPMD computes for the layout."""
    run = meshed[arch]["train"]
    _close_step(run["params"], reference[arch]["gspmd"], run["metrics"][0],
                reference[arch]["gspmd_metrics"])


# -- (c) shard sizes -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_block_of_every_fsdp_leaf_and_its_adamw_state(meshed, arch):
    run = meshed[arch]["train"]
    whole = dict(_leaves(run["whole_shapes"]))
    specs = dict(_leaves(run["specs"]))
    extent = {"data": 2, "model": 2}
    split = 0
    for r in run["resident"]:
        for tree in ("params", "master", "m", "v"):
            for path, shape in _leaves(r[tree]):
                want = list(whole[path])
                for dim, entry in enumerate(specs[path]):
                    for a in (entry if isinstance(entry, tuple) else (entry,)):
                        if a:
                            want[dim] //= extent[a]
                assert tuple(shape) == tuple(want), (tree, path, shape, want)
    embed_split = [p for p, spec in specs.items()
                   if any(e is not None and "data" in (e if isinstance(e, tuple) else (e,))
                          for e in spec)]
    split = sum(int(np.prod(whole[p])) for p in embed_split)
    total = sum(int(np.prod(s)) for s in whole.values())
    assert split > 0.9 * total, (split, total)  # FSDP holds nearly every weight split
    # parameters + master + m + v (fp32 each): a rank holds a quarter (or a
    # half, for a leaf split over one axis) of every split leaf, all of a
    # replicated one
    for r in run["resident"]:
        want = 0
        for path, shape in whole.items():
            n = int(np.prod(shape))
            for entry in specs[path]:
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a:
                        n //= extent[a]
            want += 4 * 4 * n
        assert r["bytes"] == want
        assert r["bytes"] < 0.6 * 16 * total


# -- (f) collectives ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_the_fsdp_gathers_are_counted_and_no_gradient_is_meaned_twice(meshed, arch):
    run = meshed[arch]["train"]
    counts = run["counts"]
    layout, embed = ranks.LAYOUTS[arch]
    for axis in embed:
        assert counts["fsdp_gather"][axis]["calls"] > 0, counts
        assert counts["fsdp_reduce_scatter"][axis]["calls"] > 0, counts
    # the forward gathers again in the recompute (remat full): more gathers
    # than reduce-scatters, one reduce-scatter per gathered leaf and axis
    assert counts["fsdp_gather"][embed[0]]["calls"] > \
        counts["fsdp_reduce_scatter"][embed[0]]["calls"]
    specs = [spec for _, spec in _leaves(run["specs"])]
    tokens = ("data", "model") if layout != "megatron_tp" else ("data",)
    assert len(run["grad_sums"]) == len(specs)
    for spec, summed in zip(specs, run["grad_sums"]):
        held = {a for e in spec for a in (e if isinstance(e, tuple) else (e,)) if a}
        assert set(summed) == set(tokens) - held, (spec, summed)
    assert any(summed == () for summed in run["grad_sums"])  # FSDP leaves: no mean
    batch_axes = ("data", "model") if layout == "dp_fsdp" else ("data",)
    assert all(s == batch_axes for s in run["metric_sums"]), run["metric_sums"]
    assert meshed[arch]["logits_counts"]["fsdp_gather"], meshed[arch]["logits_counts"]


# -- (d) serving ----------------------------------------------------------------------

PROMPT_LENS = (7, 12, 20, 16)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]
    solo = rng.integers(0, 512, (2, 9)).astype(np.int32)
    got = on_mesh(functools.partial(ranks.serving, RECURRENT, prompts, solo))
    return prompts, solo, got


@pytest.mark.parametrize("arch", RECURRENT)
def test_greedy_tokens_on_a_2x2_dp_fsdp_mesh_equal_the_unmeshed_server(served, arch):
    from repro_torch.runtime.server import Server, ServerConfig

    prompts, solo, got = served
    srv = Server(ranks.woven(arch, "serve", {}), ServerConfig(max_cache_len=48,
                                                              decode_tokens=5),
                 device="cpu")
    run = got[arch]
    assert run["layout"] == "dp_fsdp"
    assert run["batch"] == [b.tolist() for b in srv.serve_batch(prompts)]
    assert run["solo"] == srv.serve(solo).tolist()
    assert run["rows"] == [[0], [1], [2], [3]]  # each rank served its request
    assert run["counts"]["fsdp_gather"]["model"]["calls"] > 0


@pytest.mark.parametrize("entry", ["prefill", "decode", "server"])
def test_fsdp_sp_serving_is_refused(served, entry):
    """Served under `fsdp_sp` since ROADMAP item 15a-ii (the name is the
    refusal this test checked before): gemma-2b's entry points on the mesh,
    its FSDP blocks gathered at use, give the unmeshed port's logits or
    tokens."""
    got, want = served[2]["fsdp_sp_serving"], ranks.fsdp_sp_serving(None)
    assert got["layout"] == "fsdp_sp"
    if entry == "server":
        assert got[entry] == want[entry]
    else:
        assert rel_rms(got[entry], want[entry]) < REL_TOL


# -- (e) checkpoints ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.nn.module import init_params

    dirs = {}
    for arch in ("rwkv6-3b", "gemma-2b"):
        d = tmp_path_factory.mktemp(f"reshard_{arch}")
        w = ranks.woven(arch, "train", {})
        params = init_params(w.program.model, 3, device="cpu")
        Checkpointer(str(d), async_save=False).save(
            5, {"params": params, "opt": {"count": torch.zeros(())}})
        dirs[arch] = (str(d), {p: tuple(x.shape) for p, x in _leaves(params)})
    ckpt = tmp_path_factory.mktemp("fsdp_trainer")
    got = on_mesh(functools.partial(ranks.checkpoints, "recurrentgemma-2b", str(ckpt),
                                    {a: d for a, (d, _) in dirs.items()}))
    return str(ckpt), dirs, got


def test_a_meshed_fsdp_trainer_checkpoints_whole_state_one_device_restores(checkpoints):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    ckpt, _, got = checkpoints
    every, whole, (index, count) = got["trainer"]
    assert (index, count) == (0, 1)
    assert [e[:3] for e in every] == [(True, 2, True)] * 4
    one = Trainer(ranks.woven("recurrentgemma-2b", "train", {}, {"accum_steps": 1}),
                  TokenPipeline(PipelineConfig(vocab=512, seq_len=16, global_batch=4)),
                  TrainerConfig(ckpt_dir=ckpt, log_every=0))
    assert one.maybe_restore() and one.step == 2
    got_whole = dict(_leaves(ranks.to_host(one.params)))
    shapes = dict(_leaves(every[0][3]))
    smaller = 0
    for path, w in _leaves(whole):
        np.testing.assert_array_equal(got_whole[path], w, err_msg=path)
        smaller += int(np.prod(shapes[path])) < w.size
    assert smaller > 0  # the restored meshed trainer holds blocks, not leaves


@pytest.mark.parametrize("arch", ["rwkv6-3b", "gemma-2b"])
def test_reshard_params_onto_a_2x2_mesh_under_fsdp_rules_bit_for_bit(checkpoints, arch):
    _, dirs, got = checkpoints
    step, every = got["reshard"][arch]
    assert step == 5 and len(every) == 4
    shapes = dirs[arch][1]
    for verdicts in every:
        assert len(verdicts) == len(shapes)
        assert all(ok for *_, ok in verdicts), [v for v in verdicts if not v[-1]]
    # leaves split over both axes: a quarter of the whole
    assert any(int(np.prod(g)) * 4 == int(np.prod(w)) for _, g, w, _ in every[0])


# -- what the rules admit ----------------------------------------------------------------

def _fake_live_mesh():
    from repro_torch.launch.mesh import Mesh

    return Mesh(("data", "model"), (2, 2), (torch.device("cpu"),) * 4, (0, 0),
                (object(), object()), "gloo")


@pytest.mark.parametrize("case", [
    ("megatron_tp", {"batch": ("data",), "embed": ("model",)}, "same tokens"),
    ("megatron_tp", {"batch": ("data",), "res_seq": "model"}, "15a-iii"),
    ("fsdp_sp", {"batch": ("data",), "res_seq": "model", "seq_act": None}, "one axis"),
    ("fsdp_sp", {"batch": ("data",), "res_seq": "model", "seq_act": "model",
                 "mlp": "model"}, "not tensor-parallel"),
    ("dp_fsdp", {"batch": ("data", "model"), "experts": "model"}, "15b"),
])
def test_check_layout_refuses_what_no_layout_of_autoshard_runs(case):
    from repro_torch.distributed.sharding import check_layout

    layout, rules, says = case
    with pytest.raises(NotImplementedError, match=says):
        check_layout(_fake_live_mesh(), rules, layout)


def test_the_gather_plan_lists_the_embed_dims_the_rules_split():
    from repro_torch.distributed.sharding import gather_plan

    w = ranks.woven("qwen2-72b", "train", {"data": 2, "model": 2})
    plan = dict(_leaves(gather_plan(w.program.model, _fake_live_mesh(), w.state.rules)))
    assert plan["/embed/table"] == ((1, ("data",)),)
    assert plan["/blocks0/block/attn/wq"] == ((1, ("data",)),)  # (L, embed, heads)
    assert plan["/blocks0/block/attn/wo"] == ((2, ("data",)),)
    assert plan["/blocks0/block/attn/bq"] == ()
    whole = ranks.woven("qwen2-72b", "train", {"data": 2, "model": 2},
                        {"rules": {"embed": None}})
    assert gather_plan(whole.program.model, _fake_live_mesh(), whole.state.rules) is None
