"""PyTorch port on a live mesh: serving under AutoShard's `fsdp_sp`.  Four
gloo ranks on the CPU (`run_on_mesh`, one thread each) serve reduced
gemma-2b, mixtral-8x22b (its window of 16 passed: ring caches and a ring
pool), whisper-small (16 frames) and internvl2-1b (an image prefix of 8) on
(2, 2) under the forced layout, yi-6b, mixtral-8x22b and whisper-small with
15 frames (no axis divides them) on (1, 4) under the forced layout, and
internvl2-1b
with 6 heads on (1, 4), where AutoShard picks `fsdp_sp` by itself.  Each
rank holds its share of every KV cache and page pool (`sharding.seq_share`:
a dense cache's block of T / n slots, ps / n slots of every page), attends
it and merges the ranks' partial softmax sums (`combine_attention`).  Held
against the reference on the same numpy inputs and weights, and against
the port without a mesh.

(a) fp32 prefill logits against the reference's prefill; (b) greedy tokens
of `serve` (with frames or the image prefix; a prompt the axis divides and
one it does not), `serve_batch`, `serve_continuous` (prefix sharing),
chunked prefill and k = 2 speculative against the reference's unmeshed
server (or its prefill / decode steps where the reference's server takes no
frames) and the port's unmeshed server; (c) the int8 pool: its scales equal
on every rank and the unmeshed pool's, every code at most one step from the
unmeshed pool's, the first logits at the logit gate; (d) each rank's pool
is (P, ps / n, K, D), a cache leaf (B, T / n, K, D) where the axis divides
T and whole where it does not, and the cross caches come back unwritten;
(e) MoE routing bit for bit across ranks; (f) the reference's decode step
executed by GSPMD under the same rules on four host devices, its cache
placed by `input_shardings`, against the port's meshed decode logits; (h)
the launchers' entry point, `launch/serve.build_server(...,
layout="fsdp_sp")`, on (1, 4) against the server it builds without a mesh.
The rank bodies are in `_torch_serving_sp_ranks.py`."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_serving_sp_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 240
RUNS = sorted(ranks.RUNS)
TEXT = sorted(ranks.TEXT)
REL_TOL = 1e-4  # the bounds of tests/test_torch_mesh_parallel.py
# the logit gate of chip_smoke.py (worst logit / RMS error, shares of the
# largest logit) for the int8 pool's and the bf16 entry point's first logits
LOGIT_MAX_TOL, LOGIT_RMS_TOL = 2e-2, 1e-2
_rng = np.random.default_rng(7)
_PREFIX = _rng.integers(0, 512, 16)
REQUESTS = {
    "tokens": _rng.integers(0, 512, (2, 12)).astype(np.int32),
    # 12 tokens the axes divide, 11 they do not
    "batch": [_rng.integers(0, 512, n).astype(np.int32) for n in (12, 11)],
    # past mixtral's window of 16: ring caches
    "moe_batch": [_rng.integers(0, 512, n).astype(np.int32) for n in (18, 21)],
    # a shared prefix of 16 (two pages of 8); past mixtral's window
    "continuous": [np.concatenate([_PREFIX, _rng.integers(0, 512, n)]).astype(np.int32)
                   for n in (3, 5, 8)],
}
GSPMD_RUN = "gemma-2b"


def on_mesh(fn, shape=(2, 2)):
    return run_on_mesh(fn, shape, backend="gloo", device="cpu", threads=1,
                       timeout_s=TIMEOUT_S)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


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


# the reference, in one subprocess of four host devices: each run's weights,
# its fp32 prefill logits and its unmeshed server's greedy tokens (through
# its prefill and decode steps where its server takes no frames), and one
# decode step executed by GSPMD under fsdp_sp's rules
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import SHAPES
    from repro.core.program import Program
    from repro.core.strategies.parallelization import AutoShard
    from repro.distributed.sharding import input_shardings, param_shardings
    from repro.launch.mesh import make_test_mesh
    from repro.launch.weave import default_weave
    from repro.models.registry import build_model, reduced_config
    from repro.nn.dtypes import PolicyResolver
    from repro.nn.module import init_params
    from repro.runtime.server import Server, ServerConfig
    from repro.runtime.steps import build_decode_step, build_prefill_step

    runs, text, extra, serve, gspmd = {runs!r}, {text!r}, {extra!r}, {serve!r}, {gspmd!r}
    inputs = np.load({inputs!r})
    f32 = PolicyResolver.default("f32")
    out = {{}}

    def put(prefix, tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(prefix, v, path + "/" + k)
        else:
            out[prefix + path] = np.asarray(tree, np.float32)

    def feed(run, n=None):
        side = {{k.split("/", 1)[1]: jnp.asarray(inputs[k]) for k in inputs.files
                 if k.startswith(run + "/")}}
        toks = inputs["tokens"] if n is None else inputs["tokens"][:, :n]
        return {{"tokens": jnp.asarray(toks), **side}}

    def greedy(w, params, x, n):
        pre, dec = jax.jit(build_prefill_step(w)), jax.jit(build_decode_step(w))
        logits, cache = pre(params, x)
        B, S = x["tokens"].shape
        pos = S + (x["embeds"].shape[1] if "embeds" in x else 0)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks = []
        for _ in range(n):
            toks.append(tok)
            logits, cache = dec(params, {{"tokens": tok,
                                          "positions": jnp.full((B, 1), pos, jnp.int32)}}, cache)
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            pos += 1
        return np.concatenate([np.asarray(t) for t in toks], 1), logits

    for run, (arch, shape, forced, changes, side) in sorted(runs.items()):
        cfg = reduced_config(arch).replace(**{{"head_dim": 64, **changes}})
        model = build_model(cfg)
        params = init_params(model, jax.random.PRNGKey(0), f32)
        put(run + "|params", params)
        w = default_weave(Program(model=model, cfg=cfg, kind="serve"), SHAPES["prefill_32k"],
                          {{}}, overrides={{"tuned_kernels": False, **extra}})
        w.state.policies = f32
        w.state.extra["cache_max_len"] = serve["max_cache_len"]
        x = feed(run)
        logits, cache = jax.jit(build_prefill_step(w))(params, x)
        out[run + "|prefill"] = np.asarray(logits[:, -1], np.float32)
        if side:
            out[run + "|serve"], _ = greedy(w, params, x, serve["decode_tokens"])
            out[run + "|serve_odd"], _ = greedy(w, params, feed(run, 11),
                                                serve["decode_tokens"])
        if run in text:
            srv = Server(w, ServerConfig(max_cache_len=serve["max_cache_len"],
                                         decode_tokens=serve["decode_tokens"]))
            srv.params = params
            if not side:
                out[run + "|serve"] = srv.serve(inputs["tokens"])
            key = "moe_batch" if cfg.family == "moe" else "batch"
            batch = [inputs[f"{{key}}{{i}}"] for i in range(2)]
            for i, t in enumerate(srv.serve_batch(batch)):
                out[f"{{run}}|batch{{i}}"] = np.asarray(t)
            prompts = [inputs[f"continuous{{i}}"] for i in range(3)]
            for tag, kw in (("continuous", {{}}), ("chunked", {{"prefill_chunk": 8}}),
                            ("speculative", {{"draft_len": 2}})):
                if tag != "continuous" and run != "gemma-2b":
                    continue  # one run's chunked and speculative serves
                for i, t in enumerate(srv.serve_continuous(prompts, page_size=serve["page_size"],
                                                           **kw)):
                    out[f"{{run}}|{{tag}}{{i}}"] = np.asarray(t)
        if run == gspmd:
            mesh = make_test_mesh(tuple(shape), ("data", "model"))
            wm = default_weave(Program(model=model, cfg=cfg, kind="serve"),
                               SHAPES["prefill_32k"], dict(mesh.shape),
                               overrides={{"tuned_kernels": False, **extra}},
                               extra_aspects=[AutoShard(dict(mesh.shape), train=False,
                                                        layout="fsdp_sp")])
            wm.state.policies = f32
            assert wm.state.extra["layout"] == "fsdp_sp"
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            step = {{"tokens": tok, "positions": jnp.full(tok.shape, x["tokens"].shape[1],
                                                          jnp.int32)}}
            ps = param_shardings(model, mesh, wm.state.rules)
            cs = input_shardings(cache, mesh, wm.state.rules)
            ins = input_shardings(step, mesh, wm.state.rules)
            dec = jax.jit(build_decode_step(wm, mesh=mesh), in_shardings=(ps, ins, cs))
            got, _ = dec(jax.device_put(params, ps), jax.device_put(step, ins),
                         jax.device_put(cache, cs))
            out[run + "|gspmd_decode"] = np.asarray(got[:, -1], np.float32)
            k = cache["blocks0"]["k"]
            out[run + "|gspmd_cache_shard"] = np.asarray(cs["blocks0"]["k"].shard_shape(k.shape))
            out[run + "|gspmd_cache_whole"] = np.asarray(k.shape)
    np.savez({out!r}, **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, prefill logits and tokens by run."""
    tmp = tmp_path_factory.mktemp("serving_sp_reference")
    arrays = {"tokens": REQUESTS["tokens"]}
    for key in ("batch", "moe_batch", "continuous"):
        for i, p in enumerate(REQUESTS[key]):
            arrays[f"{key}{i}"] = p
    for run in RUNS:
        for k, v in ranks.side_inputs(run, REQUESTS["tokens"].shape[0]).items():
            arrays[f"{run}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    script = REFERENCE.format(src=SRC, runs=ranks.RUNS, text=list(ranks.TEXT),
                              extra=ranks.EXTRA, serve=ranks.SERVE, gspmd=GSPMD_RUN,
                              inputs=str(tmp / "in.npz"), out=str(tmp / "out.npz"))
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    flat = dict(np.load(tmp / "out.npz"))
    out = {}
    for r in RUNS:
        out[r] = {k.split("|", 1)[1]: v for k, v in flat.items()
                  if k.startswith(r + "|") and "/" not in k}
        out[r]["params"] = _tree(flat, f"{r}|params")
    return out


@pytest.fixture(scope="module")
def served(reference):
    """Every run's results on its mesh (each rank's) and without a mesh."""
    params = {r: reference[r]["params"] for r in RUNS}
    meshed = on_mesh(functools.partial(ranks.served, params, REQUESTS))
    unmeshed = {r: ranks.serve_run(r, params[r], REQUESTS) for r in RUNS}
    unmeshed["build_server"] = ranks.entry_point_run(REQUESTS)
    return meshed, unmeshed


def _rows(ref, run, tag, n):
    return [ref[run][f"{tag}{i}"].tolist() for i in range(n)]


# -- (a) logits -------------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_a_fp32_prefill_logits_match_the_reference(served, reference, run):
    meshed, unmeshed = served
    want = reference[run]["prefill"]
    for r in meshed[run]:
        assert r["layout"] == "fsdp_sp"
        assert rel_rms(r["steps"]["prefill"], want) < REL_TOL
    assert rel_rms(unmeshed[run]["steps"]["prefill"], want) < REL_TOL


# -- (b) greedy tokens ---------------------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_b_serve_tokens_equal_the_reference_and_the_unmeshed_server(served, reference, run):
    meshed, unmeshed = served
    want = reference[run]["serve"].tolist()
    assert unmeshed[run]["serve"] == want
    for r in meshed[run]:
        assert r["serve"] == want
        if "serve_odd" in r:  # a prompt (with its prefix) the axis does not divide
            assert r["serve_odd"] == unmeshed[run]["serve_odd"] \
                == reference[run]["serve_odd"].tolist()


@pytest.mark.parametrize("run", TEXT)
def test_b_serve_batch_tokens_equal_the_reference_and_the_unmeshed_server(served, reference,
                                                                          run):
    meshed, unmeshed = served
    want = _rows(reference, run, "batch", 2)
    assert unmeshed[run]["batch"] == want
    for r in meshed[run]:
        assert r["batch"] == want


@pytest.mark.parametrize("run", TEXT)
def test_b_continuous_tokens_equal_the_reference_and_the_unmeshed_server(served, reference,
                                                                         run):
    meshed, unmeshed = served
    want = _rows(reference, run, "continuous", 3)
    assert unmeshed[run]["continuous"] == want
    for r in meshed[run]:
        assert r["continuous"] == want
        # chunked prefill and a self draft at k = 2 serve plain greedy's tokens
        assert r["chunked"] == unmeshed[run]["chunked"] == want
        assert r["speculative"] == unmeshed[run]["speculative"] == want
    if run == "gemma-2b":
        assert _rows(reference, run, "chunked", 3) == want
        assert _rows(reference, run, "speculative", 3) == want
        for r in meshed[run]:  # the verify steps ran on the mesh
            assert r["spec_stats"]["verify_steps"] > 0, r["spec_stats"]


# -- (c) the int8 pool ------------------------------------------------------------------

@pytest.mark.parametrize("run", sorted(ranks.QUANT))
def test_c_int8_pool_scales_codes_and_first_logits(served, run):
    meshed, unmeshed = served
    one = unmeshed[run]["int8_pool"]
    n = ranks.RUNS[run][1][1]
    agree = []
    for r in meshed[run]:
        pool = r["int8_pool"]
        for key, want in one["snapshot"].items():
            if key.endswith(("ksc", "vsc")):  # whole and equal on every rank
                np.testing.assert_allclose(pool["snapshot"][key], want, rtol=1e-5, atol=0,
                                           err_msg=key)
        assert len(pool["first"]) == len(one["first"]) == len(REQUESTS["continuous"])
        for got, want in zip(pool["first"], one["first"]):
            top = np.abs(want).max()
            assert np.abs(got - want).max() <= LOGIT_MAX_TOL * top
            assert np.sqrt(np.mean((got - want) ** 2)) <= LOGIT_RMS_TOL * top
        agree.append(np.mean([a == b for x, y in zip(r["int8"], unmeshed[run]["int8"])
                              for a, b in zip(x, y)]))
    # every code at most one step from the unmeshed pool's, rank by rank
    for coord, r in enumerate(_by_model_coord(meshed[run], n)):
        for key, want in one["snapshot"].items():
            if key.endswith(("pk", "pv")):
                sub = want.shape[-3] // n
                mine = want[..., coord * sub:(coord + 1) * sub, :, :]
                got = r["int8_pool"]["snapshot"][key]
                assert np.abs(got.astype(np.int32) - mine.astype(np.int32)).max() <= 1, key
    print(f"{run} int8 pool: token agreement with the unmeshed server {agree}")


def _by_model_coord(results, n):
    """One rank's results per `model` coordinate (the ranks of one `data`
    row hold the same; spawn order is row-major over (data, model))."""
    return results[:n]


# -- (d) shares of the caches and pools ------------------------------------------------------

@pytest.mark.parametrize("run", RUNS)
def test_d_each_rank_holds_its_share_of_every_cache_and_pool(served, run):
    meshed, unmeshed = served
    n = ranks.RUNS[run][1][1]
    whole = unmeshed[run]
    for r in meshed[run]:
        B, T, K, D = whole["steps"]["self_k"][-4:]
        assert r["steps"]["self_k"][-3] == (T // n if T % n == 0 else T)
        if "cross_k" in whole["steps"]:
            F = whole["steps"]["cross_k"][-3]
            assert r["steps"]["cross_k"][-3] == (F // n if F % n == 0 else F)
            assert r["steps"]["cross_unwritten"]
        if run in ranks.TEXT:  # the continuous, chunked and speculative serves' pools
            assert len(r["pools"]) == len(whole["pools"]) >= 3
        for (name, got), (_, want) in zip(r.get("pools", []), whole.get("pools", [])):
            assert got[-3] * n == want[-3] and got[:-3] == want[:-3] \
                and got[-2:] == want[-2:], (name, got, want)
        if "stats" in r:
            assert r["stats"]["page_hbm_bytes"] * n == whole["stats"]["page_hbm_bytes"]
        # the partial softmax sums merged over the sequence axis, counted
        assert r["counts"]["attention_combine"]["model"]["calls"] > 0


# -- (e) MoE routing -----------------------------------------------------------------------

@pytest.mark.parametrize("run", ["mixtral-8x22b", "mixtral-8x22b@1x4"])
def test_e_moe_routing_is_identical_on_every_rank_and_the_unmeshed_layers(served, run):
    meshed, unmeshed = served
    want = unmeshed[run]["routing"]
    assert want
    for r in meshed[run]:
        assert len(r["routing"]) == len(want)
        for got, one in zip(r["routing"], want):
            for key in ("experts", "ranks", "keep"):
                np.testing.assert_array_equal(got[key], one[key])


# -- (f) GSPMD ----------------------------------------------------------------------------

def test_f_meshed_decode_logits_match_the_reference_under_gspmd(served, reference):
    meshed, _ = served
    want = reference[GSPMD_RUN]["gspmd_decode"]
    whole, shard = reference[GSPMD_RUN]["gspmd_cache_whole"], \
        reference[GSPMD_RUN]["gspmd_cache_shard"]
    n = ranks.RUNS[GSPMD_RUN][1][1]
    assert shard[-3] * n == whole[-3]  # GSPMD's cache: the sequence over `model`
    for r in meshed[GSPMD_RUN]:
        assert r["steps"]["self_k"][-3] == shard[-3]
        assert rel_rms(r["steps"]["decode"], want) < REL_TOL


# -- (g) a rank's share of a cache, as `input_shardings` places it ------------------------

@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("T", [64, 30, 15])
def test_g_seq_share_is_the_block_input_shardings_gives_a_dense_cache(shape, T):
    """`sharding.seq_share` of a dense cache's T slots is, on every rank of
    the mesh, the block of the sequence dim that `input_shardings` and
    `local_shard` give its K / V leaf under fsdp_sp's rules (None where the
    axis does not divide T: the leaf stays whole)."""
    from repro_torch.distributed.sharding import input_shardings, local_shard, seq_share
    from repro_torch.launch.mesh import Mesh

    rules = {"batch": ("data",), "kv_seq": "model", "seq_act": "model", "res_seq": "model"}
    slots = torch.arange(T, dtype=torch.float32).reshape(1, 1, T, 1, 1).expand(2, 2, T, 1, 2)
    for rank in range(shape[0] * shape[1]):
        coords = divmod(rank, shape[1])
        mesh = Mesh(("data", "model"), shape, (torch.device("cpu"),) * (shape[0] * shape[1]),
                    coords, (object(), object()), "gloo")
        sh = input_shardings({"k": slots}, mesh, rules)["k"]
        held = local_shard(slots, sh)[0, 0, :, 0, 0].tolist()
        share = seq_share(mesh, rules, T)
        if share is None:
            assert held == list(range(T)) and sh.dim_axes(2) == ()
        else:
            sub, span, phase = share
            assert (span, sh.dim_axes(2)) == (T, ("model",))
            assert held == list(range(phase, phase + sub))


# -- (h) the launchers' entry point ---------------------------------------------------------

def test_h_build_server_serves_under_the_layout_it_forces(served):
    """`launch/serve.build_server(..., layout="fsdp_sp")` on (1, 4) (where
    AutoShard by itself picks `megatron_tp` for gemma-2b's 4 heads): every
    rank serves under `fsdp_sp`, its pools hold ps / 4 slots of every page,
    and each admission's first logits are at the logit gate of those of the
    server `build_server` builds without a mesh.  The launchers serve in
    bf16, where a near tie may round the other way: the greedy tokens'
    agreement is printed, not gated (the fp32 runs above gate them)."""
    meshed, unmeshed = served
    one = unmeshed["build_server"]
    assert one["layout"] == "megatron_tp"
    agree = []
    for r in meshed["build_server"]:
        assert (r["layout"], r["kv_seq"]) == ("fsdp_sp", "model")
        assert len(r["pools"]) == len(one["pools"]) >= 1
        for (_, got), (_, want) in zip(r["pools"], one["pools"]):
            assert got[-3] * ranks.ENTRY_MESH[1] == want[-3] and got[-2:] == want[-2:]
        assert len(r["first"]) == len(one["first"]) == len(REQUESTS["continuous"])
        for got, want in zip(r["first"], one["first"]):
            top = np.abs(want).max()
            assert np.abs(got - want).max() <= LOGIT_MAX_TOL * top
            assert np.sqrt(np.mean((got - want) ** 2)) <= LOGIT_RMS_TOL * top
        agree.append(np.mean([a == b for x, y in zip(r["continuous"] + r["serve"],
                                                     one["continuous"] + one["serve"])
                              for a, b in zip(x, y)]))
    print(f"build_server under fsdp_sp: token agreement with the unmeshed server {agree}")
