"""PyTorch port on a live mesh: the MoE, encoder-decoder and VLM families
trained under AutoShard's `fsdp_sp`.  Four gloo ranks on the CPU
(`run_on_mesh`, one thread each) run reduced mixtral-8x22b, grok-1-314b,
whisper-small and internvl2-1b with a vocab of 515 (which neither a 2- nor
a 4-way sequence axis divides, as whisper-small's 51865 and internvl2-1b's
151655 rows divide none) through the port's entry points, each rank on its
block of the sequence: on (2, 2) under the forced layout (mixtral-8x22b
again with `embed` FSDP over `(data, model)`; whisper-small with frames the
axis divides and frames it does not, and once with a vocab of 512 the axis
divides; internvl2-1b with its image prefix),
and internvl2-1b with 6 heads on (1, 4), where AutoShard picks `fsdp_sp` by
itself.  Held against the reference on the same numpy inputs and against
the port without a mesh.

(a) fp32 dense logits against the reference's `apply` (a rank's logits are
its block of positions over the whole vocab); (b) one train step against
the reference's jitted unmeshed step, the port's unmeshed step and the
reference's step executed by GSPMD under the same rules on four host
devices (one JAX subprocess); (c) MoE routing: every rank's experts,
capacity ranks and keep mask bit for bit the unmeshed layer's on its rows,
the first MoE layer alone on a rank's block giving the unmeshed output and
input gradient, `moe_drop_frac` equal on every rank; (d) each rank holds
its blocks and their AdamW state; (e) the gradient of the initial weights,
the embedding's and the head's among them, equals the unmeshed one (the
sum over the sequence axis adds nothing twice); (f) serving under
`fsdp_sp` (ROADMAP item 15a-ii): the meshed prefill and decode logits and
the server's tokens are the unmeshed port's; a meshed trainer's checkpoint
restores on one device bit for bit, and `reshard_params` puts each rank's
blocks (a whole vocab whole) onto the mesh.  The rank bodies are in
`_torch_family_sp_ranks.py`.  The file takes about 120 s on four CPU
threads."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_family_sp_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 240
RUNS = sorted(ranks.RUNS)
MOE_RUNS = [r for r in RUNS if ranks.RUNS[r][0] in ranks.MOE and ranks.RUNS[r][2] is None]
REL_TOL = 1e-4  # the bounds of tests/test_torch_mesh_parallel.py
# internvl's K bias (a Qwen2 backbone) has a gradient of zero in exact
# arithmetic (the softmax ignores a shift every key shares): what reaches
# Adam is the rounding of the sum, which sets the sign of its one-step
# update — the exemption `tests/test_torch_mesh_families.py` makes
ZERO_GRAD_TOL = {"/blocks0/block/attn/bk": 1e-3}
BATCH = {"vocab": 512, "seq_len": 16, "global_batch": 4}
TOKENS = np.random.default_rng(1).integers(0, 512, (4, 12)).astype(np.int32)
EXTENT = {(2, 2): {"data": 2, "model": 2}, (1, 4): {"data": 1, "model": 4}}


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


def _arch_key(run):
    """The runs that share weights: one arch at one config."""
    arch, _, _, _, changes, _ = ranks.RUNS[run]
    return arch + "".join(f"+{k}{v}" for k, v in sorted(changes.items()))


# the reference, in one subprocess of four host devices: each config's
# weights, and each run's logits, jitted unmeshed train step and step
# executed by GSPMD under the run's rules on its mesh
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

    runs, keys, vocab, extra_blocks = {runs!r}, {keys!r}, {vocab!r}, {extra!r}
    inputs = np.load({inputs!r})
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
        keys_ = [k.split("|", 1)[1] for k in inputs.files if k.startswith(run + "|" + kind)]
        return {{k.split("/", 1)[1]: jnp.asarray(inputs[run + "|" + k]) for k in keys_}}

    models = {{}}
    for run, (arch, shape, embed, forced, changes, _) in sorted(runs.items()):
        key = keys[run]
        cfg = reduced_config(arch).replace(**{{"head_dim": 64, "vocab": vocab, **changes}})
        if key not in models:
            model = build_model(cfg)
            params = init_params(model, jax.random.PRNGKey(0), f32)
            models[key] = (model, params)
            put(key + "|params", params)
        model, params = models[key]
        fwd = jax.jit(lambda p, x: model(p, x, ctx=Ctx(policies=f32), mode="dense")[0])
        out[run + "|logits"] = np.asarray(fwd(params, feed(run, "logits")), np.float32)
        batch = feed(run, "batch")
        mesh = make_test_mesh(shape, ("data", "model"))

        def woven(axes):
            extra = None
            if forced:
                extra = [AutoShard(axes, train=True, layout="fsdp_sp"),
                         ShardingAspect({{"embed": embed}})]
            w = default_weave(Program(model=model, cfg=cfg, kind="train"),
                              SHAPES["train_4k"], axes,
                              overrides={{"accum_steps": 1, "remat": "full",
                                         "tuned_kernels": False,
                                         "rules": {{"embed": embed}}, **extra_blocks}},
                              extra_aspects=extra)
            w.state.policies = f32
            return w

        opt = adamw.init_state(params, adamw.AdamWConfig())
        step = jax.jit(build_train_step(woven({{}}), lr_fn=lr, opt_cfg=opt_cfg))
        p, _, m = step(params, opt, batch, jnp.asarray(0, jnp.int32))
        put(run + "|step", p)
        out[run + "|step_metrics/loss"] = np.asarray(m["loss"])
        out[run + "|step_metrics/grad_norm"] = np.asarray(m["grad_norm"])
        w = woven(dict(mesh.shape))
        assert w.state.extra["layout"] == "fsdp_sp", w.state.extra["layout"]
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
    """The reference's weights (one tree a config), and its logits,
    unmeshed step and GSPMD step by run."""
    tmp = tmp_path_factory.mktemp("family_sp_reference")
    arrays = {}
    for run in RUNS:
        for k, v in {"tokens": TOKENS, **ranks.side_inputs(run, TOKENS.shape[0])}.items():
            arrays[f"{run}|logits/{k}"] = v
        for k, v in _batch(run).items():
            arrays[f"{run}|batch/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    keys = {r: _arch_key(r) for r in RUNS}
    script = REFERENCE.format(src=SRC, runs=ranks.RUNS, keys=keys, vocab=ranks.VOCAB,
                              extra=ranks.EXTRA, inputs=str(tmp / "in.npz"),
                              out=str(tmp / "out.npz"), lr=ranks.LR, eps=ranks.ADAM_EPS)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    flat = dict(np.load(tmp / "out.npz"))
    out = {}
    for r in RUNS:
        out[r] = {k: _tree(flat, f"{r}|{k}")
                  for k in ("step", "step_metrics", "gspmd", "gspmd_metrics")}
        out[r]["params"] = _tree(flat, f"{keys[r]}|params")
        out[r]["logits"] = flat[f"{r}|logits"]
    return out


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's own unmeshed train step and gradient of each run from the
    reference's weights."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_grad_fn, build_train_step

    out = {}
    for run in RUNS:
        w = ranks.woven(run, "train", {}, {"accum_steps": 1, "remat": "full"})
        params = ranks.whole_params(w, reference[run]["params"])
        batch = ranks.tensors(_batch(run))
        (loss, _), grads = build_grad_fn(w)(params, batch)
        step = build_train_step(w, lr_fn=lambda s: ranks.schedule.constant(s, peak=ranks.LR),
                                opt_cfg=adamw.AdamWConfig(eps=ranks.ADAM_EPS))
        grads = ranks.to_host(grads)
        params, _, m = step(params, adamw.init_state(params, adamw.AdamWConfig()), batch, 0)
        out[run] = {"params": ranks.to_host(params), "grads": grads, "loss": float(loss),
                    "metrics": {k: float(v) for k, v in m.items()}}
    return out


@pytest.fixture(scope="module")
def meshed(reference):
    """(a)-(e) of every run in one spawn of four ranks."""
    return on_mesh(functools.partial(
        ranks.suite, {r: reference[r]["params"] for r in RUNS}, TOKENS,
        {r: _batch(r) for r in RUNS}))


# -- (a) logits ------------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_logits_under_fsdp_sp_match_the_reference(meshed, reference, run):
    got = meshed[run]["logits"]
    assert got["layout"] == "fsdp_sp"
    np.testing.assert_allclose(got["logits"], reference[run]["logits"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("run", RUNS)
def test_a_rank_s_logits_are_its_block_of_positions_or_of_the_vocab(meshed, run):
    """A vocab the axis does not divide stays whole (the rules drop `model`
    from a dim it does not divide), and the logits are the rank's rows and
    block of the P + T positions; one it divides gives the rank's vocab
    block over the whole sequence."""
    got = meshed[run]["logits"]
    _, shape, _, _, _, side = ranks.RUNS[run]
    cfg = ranks.config(run)
    S = (side if cfg.family == "vlm" else 0) + TOKENS.shape[1]
    rows = TOKENS.shape[0] // shape[0]
    if cfg.vocab == ranks.VOCAB:
        assert got["block"] == (rows, S // shape[1], cfg.vocab)
    else:
        assert got["block"] == (rows, S, cfg.vocab // shape[1])
    assert got["logits"].shape == (TOKENS.shape[0], S, cfg.vocab)


def test_autoshard_picks_fsdp_sp_for_internvl_with_6_heads_on_1x4(meshed):
    """6 heads do not divide a 4-way `model` axis: AutoShard's own choice,
    with no `layout=` forced (`RUNS`), is `fsdp_sp`."""
    run = "internvl2-1b@1x4"
    assert not ranks.RUNS[run][3]
    for kind in ("logits", "train"):
        assert meshed[run][kind]["layout"] == "fsdp_sp"
        assert meshed[run][kind]["rules"]["res_seq"] == "model"


# -- (b) one train step -------------------------------------------------------------------

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
def test_a_train_step_under_fsdp_sp_matches(meshed, reference, unmeshed, run, against):
    got = meshed[run]["train"]
    assert got["layout"] == "fsdp_sp"
    if against == "reference":
        want, want_metrics = reference[run]["step"], reference[run]["step_metrics"]
    elif against == "gspmd":
        want, want_metrics = reference[run]["gspmd"], reference[run]["gspmd_metrics"]
    else:
        want, want_metrics = unmeshed[run]["params"], unmeshed[run]["metrics"]
    _close_step(got["params"], want, got["metrics"], want_metrics)


# -- (c) MoE routing --------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_unmeshed(meshed, reference):
    """Each MoE run's routing of the logits' tokens without a mesh, and its
    first MoE layer alone on the same input."""
    out = {}
    for run in MOE_RUNS:
        w = ranks.woven(run, "train", {})
        model = w.program.model
        params = ranks.whole_params(w, reference[run]["params"])
        feed = ranks.tensors({"tokens": TOKENS})
        with ranks.RouteSpy() as spy, torch.no_grad():
            model(params, feed, ctx=w.state.make_ctx(), mode="dense")
        x = np.concatenate([c[0]["x"] for c in meshed[run]["logits"]["routing"][::2]])
        xt = torch.from_numpy(x).requires_grad_(True)
        layer = {k: v[0] for k, v in params[model.trunk[0].name]["block"]["ffn"].items()}
        ctx = w.state.make_ctx()
        ctx.taps_enabled = ["*moe_drop_frac"]
        y = model.trunk[0].template.ffn(layer, xt, ctx=ctx)
        (dx,) = torch.autograd.grad(torch.sum(y * y), xt)
        out[run] = {"routing": spy.calls, "y": y.detach().numpy(), "dx": dx.numpy(),
                    "drop": {k: float(v) for k, v in ctx.taps.items()}}
    return out


@pytest.mark.parametrize("run", MOE_RUNS)
def test_moe_routing_on_every_rank_is_the_unmeshed_layer_s_bit_for_bit(meshed,
                                                                       moe_unmeshed, run):
    """Each rank routes the whole sequence of its rows (its group spans the
    ranks' blocks): its experts, capacity ranks and keep mask are the
    unmeshed layer's on those rows, bit for bit, layer by layer."""
    got = meshed[run]["logits"]
    want = moe_unmeshed[run]["routing"]
    cfg = ranks.config(run)
    assert all(len(r) == cfg.num_layers for r in got["routing"])
    for calls, rows in zip(got["routing"], got["rows"]):
        for mine, one in zip(calls, want):
            assert mine["capacity"] == one["capacity"]
            assert mine["x"].shape[1] == TOKENS.shape[1]  # the whole sequence
            np.testing.assert_array_equal(mine["x"], one["x"][rows])
            for key in ("experts", "ranks", "keep"):
                np.testing.assert_array_equal(mine[key], one[key][rows])


@pytest.mark.parametrize("run", MOE_RUNS)
def test_the_moe_layer_on_a_rank_s_block_is_the_unmeshed_layer(meshed, moe_unmeshed, run):
    """The first MoE layer alone on each rank's block of the sequence: the
    output and the input's gradient are the unmeshed layer's block, and
    `moe_drop_frac` is the global share of the rank's rows, on every rank
    of a `data` row alike."""
    want = moe_unmeshed[run]
    every = meshed[run]["moe_layer"]
    S = TOKENS.shape[1]
    for r in every:
        d, m = r["coords"]
        rows, cols = slice(2 * d, 2 * d + 2), slice(m * S // 2, (m + 1) * S // 2)
        assert rel_rms(r["y"], want["y"][rows, cols]) < REL_TOL
        assert rel_rms(r["dx"], want["dx"][rows, cols]) < REL_TOL
        peer = next(p for p in every if p["coords"] == (d, 1 - m))
        assert r["drop"] == peer["drop"] and len(r["drop"]) == 1
    assert len({tuple(r["drop"].values()) for r in every}) >= 1
    share = [v for r in every for v in r["drop"].values()]
    assert all(0.0 <= v < 1.0 for v in share)
    assert np.isclose(np.mean(share), list(want["drop"].values())[0], atol=1e-6)


# -- (d) shard sizes -----------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_each_rank_holds_its_blocks_and_their_adamw_state(meshed, run):
    got = meshed[run]["train"]
    whole = dict(_leaves(got["whole_shapes"]))
    specs = dict(_leaves(got["specs"]))
    extent = EXTENT[ranks.RUNS[run][1]]
    for r in got["resident"]:
        for tree in ("params", "master", "m", "v"):
            for path, shape in _leaves(r[tree]):
                want = list(whole[path])
                for dim, entry in enumerate(specs[path]):
                    for a in (entry if isinstance(entry, tuple) else (entry,)):
                        if a:
                            want[dim] //= extent[a]
                assert tuple(shape) == tuple(want), (tree, path, shape, want)
    # nothing is tensor-parallel; a vocab of 515 stays whole
    table = specs["/embed/table"] or (None, None)
    assert (table[0] is None) == (ranks.config(run).vocab == ranks.VOCAB), table
    if ranks.RUNS[run][2]:  # FSDP: the table's and the head's `embed` dims split
        assert table[1] == ("data", "model") and specs["/head/w"][0] == ("data", "model")
        assert got["counts"]["fsdp_gather"]["model"]["calls"] > 0


# -- (e) the gradient ----------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_the_gradient_under_fsdp_sp_is_the_unmeshed_one(meshed, unmeshed, run):
    """The meshed gradient of the initial weights, put back together whole,
    leaf by leaf against the unmeshed one: a whole table's or head's
    gradient is the ranks' partial sums added once over the sequence axis,
    not n times."""
    got, want = meshed[run]["train"], unmeshed[run]
    assert rel_rms(got["grad_loss"], want["loss"]) < REL_TOL
    g, w = dict(_leaves(got["grads"])), dict(_leaves(want["grads"]))
    assert set(g) == set(w)
    assert "/embed/table" in w and ("/head/w" in w) != ranks.config(run).tie_embeddings
    for path in w:
        assert rel_rms(g[path], w[path]) < ZERO_GRAD_TOL.get(path, REL_TOL), \
            (path, rel_rms(g[path], w[path]))


# -- (f) serving, checkpoints -----------------------------------------------------------------

SERVE_RUNS = ["mixtral-8x22b", "whisper-small", "internvl2-1b"]


@pytest.fixture(scope="module")
def apart(tmp_path_factory):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.nn.module import init_params

    d = tmp_path_factory.mktemp("reshard_whisper")
    w = ranks.woven("whisper-small", "train", {})
    params = init_params(w.program.model, 3, device="cpu")
    Checkpointer(str(d), async_save=False).save(
        5, {"params": params, "opt": {"count": torch.zeros(())}})
    ckpt = tmp_path_factory.mktemp("fsdp_sp_trainer")
    return str(ckpt), on_mesh(functools.partial(
        ranks.apart, SERVE_RUNS, "mixtral-8x22b+embed", str(ckpt), "whisper-small", str(d)))


@functools.lru_cache(maxsize=None)
def _unmeshed_entries(run):
    return ranks.serve_results([run], None)[run]


@pytest.mark.parametrize("entry", ["prefill", "decode", "server"])
@pytest.mark.parametrize("run", SERVE_RUNS)
def test_serving_under_fsdp_sp_waits_for_15a_ii(apart, run, entry):
    """Served under `fsdp_sp` since ROADMAP item 15a-ii (the name is the
    refusal this test checked before): each entry point on the mesh gives
    the unmeshed port's logits or tokens."""
    got, want = apart[1]["served"][run], _unmeshed_entries(run)
    assert got["layout"] == "fsdp_sp"
    if entry == "server":
        assert got[entry] == want[entry]
    else:
        assert rel_rms(got[entry], want[entry]) < REL_TOL


def test_a_meshed_fsdp_sp_trainer_checkpoints_whole_state_one_device_restores(apart):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    ckpt, got = apart
    every, whole = got["trainer"]
    assert [e[:3] for e in every] == [(True, 2, True)] * 4
    losses = every[0][4]
    assert all(e[4] == losses for e in every) and np.isfinite(losses).all()
    one = Trainer(ranks.woven("mixtral-8x22b+embed", "train", {}, {"accum_steps": 1}),
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


def test_reshard_params_onto_the_mesh_keeps_a_whole_vocab_whole(apart):
    step, every = apart[1]["reshard"]
    assert step == 5 and len(every) == 4
    for verdicts in every:
        assert all(ok for *_, ok in verdicts), [v for v in verdicts if not v[-1]]
        table = next(v for v in verdicts if v[0] == "/embed/table")
        assert table[1] == table[2] == (ranks.VOCAB, ranks.config("whisper-small").d_model)


# -- what the rules lay out -------------------------------------------------------------------

def _fake_live_mesh():
    from repro_torch.launch.mesh import Mesh

    return Mesh(("data", "model"), (2, 2), (torch.device("cpu"),) * 4, (0, 0),
                (object(), object()), "gloo")


@pytest.mark.parametrize("vocab", [ranks.VOCAB, 512])
def test_the_gather_plan_and_the_shardings_agree_on_the_vocab(vocab):
    """Under `fsdp_sp` with `embed` FSDP over `(data, model)`: a vocab the
    axis does not divide leaves the table and the head whole in the vocab,
    their `embed` dim split over both axes and gathered at use; one it
    divides splits the table's rows over `model` (its `embed` dim over
    `data` alone), while the head's `embed` dim, first in its spec, takes
    both axes and leaves its vocab whole."""
    from repro_torch.distributed.sharding import gather_plan, param_shardings

    w = ranks.woven("mixtral-8x22b+embed", "train", {"data": 2, "model": 2})
    if vocab != ranks.VOCAB:
        cfg = ranks.config("mixtral-8x22b+embed").replace(vocab=vocab)
        w.program.model = ranks.build_model(cfg)
    mesh, model = _fake_live_mesh(), w.program.model
    specs = {p: sh.spec for p, sh in _leaves(param_shardings(model, mesh, w.state.rules))}
    plan = dict(_leaves(gather_plan(model, mesh, w.state.rules)))
    if vocab == ranks.VOCAB:
        assert specs["/embed/table"] == (None, ("data", "model"))
        assert plan["/embed/table"] == ((1, ("data", "model")),)
    else:
        assert specs["/embed/table"] == ("model", "data")
        assert plan["/embed/table"] == ((1, ("data",)),)
    assert specs["/head/w"] == (("data", "model"), None)
    assert plan["/head/w"] == ((0, ("data", "model")),)
