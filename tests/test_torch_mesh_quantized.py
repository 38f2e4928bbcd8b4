"""PyTorch port on a live mesh: quantized and speculative serving, int8
weights on a row-parallel product and int8 gradient compression.  Gloo
ranks on the CPU (`run_on_mesh`, one thread each) run the port's entry
points, each rank on its shard, held against the reference on the same
numpy inputs and against the port without a mesh.

(a) an int8 and an e4m3 page pool through `serve_continuous` on (1, 2) and
(2, 2), reduced yi-6b (its KV heads split over `model`) and gemma-2b (one
KV head, taken per q head), fp32: the tokens are the unmeshed port's and
the reference's, a rank's scale sidecars are the unmeshed pool's for the
heads it holds (within fp32 rounding: the ranks' activations add their
partial products in another order), and `page_hbm_bytes` counts the rank's
heads only; (b) a row-parallel `fixed` Linear on (1, 2) and (1, 4): its
codes and scales bit for bit the unmeshed ones, its fp32 product within
1e-5 of the reference's, and reduced yi-6b's `fixed` logits on (2, 2)
against the reference's `apply` and the unmeshed port; (c) one compressed
train step of one-layer reduced qwen2-72b on (2, 2) against the reference's
jitted step and the port's unmeshed step — its K / V biases (128 elements,
64 a rank) are compressed, as the whole leaves are — `ef_compress` of split
leaves bit for bit the unmeshed one, and a meshed compressed trainer's
checkpoint, `ef` included, restored by a one-device trainer; (d) fp32
speculative decoding on (1, 2) over the fp and the int8 pool: bit for bit
plain greedy on the mesh and the unmeshed speculative serve (tokens and
`last_spec_stats`), one verify step's logits against the unmeshed step's,
and a draft that is not on the target's mesh refused.  The rank bodies are
in `_torch_quant_ranks.py`."""

import functools

import numpy as np
import pytest
import torch

import _torch_quant_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

TIMEOUT_S = 120
SHAPES = [(1, 2), (2, 2)]
POOL_CASES = [(arch, dt) for arch in ("yi-6b", "gemma-2b")
              for dt in ("int8", "float8_e4m3fn")]
REL_TOL = 1e-4  # the bounds of tests/test_torch_mesh_parallel.py
# qwen2's K bias has a gradient of zero in exact arithmetic (the softmax
# ignores a shift every key shares): what reaches Adam is the rounding of
# the sum — the exemption tests/test_torch_mesh_fsdp.py makes for it
ZERO_GRAD_TOL = {"/blocks0/block/attn/bk": 1e-3}
PROMPTS = [np.arange(3, 10, dtype=np.int32),
           (np.arange(12) * 7 % 500 + 1).astype(np.int32),
           np.arange(3, 10, dtype=np.int32),  # the first one again: a shared prefix
           np.array([3, 1, 4, 1, 5], np.int32)]


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


def _case_id(case):
    return f"{case[0]}-{case[1]}"


@functools.lru_cache(maxsize=None)
def _reference_server(arch):
    """The reference's server over reduced `arch` at head_dim 64, fp32, its
    Pallas kernels in interpret mode (`test_torch_serve._servers`), and its
    weights as numpy."""
    from _torch_port import np_tree
    from test_torch_serve import _servers

    jsrv, _ = _servers(arch, head_dim=64)
    jsrv.cfg.max_cache_len = ranks.SERVE["max_cache_len"]
    jsrv.cfg.decode_tokens = ranks.SERVE["decode_tokens"]
    return jsrv, np_tree(jsrv.params)


def _np_params(arch):
    return _reference_server(arch)[1]


# -- (a) int8 / fp8 pools on a rank's KV heads ----------------------------------


@pytest.fixture(scope="module")
def pool_runs():
    """Every (arch, dtype) case served by the reference, the unmeshed port
    and each mesh shape's ranks."""
    archs = sorted({a for a, _ in POOL_CASES})
    params = {a: _np_params(a) for a in archs}
    reference = {}
    for arch, dt in POOL_CASES:
        jsrv = _reference_server(arch)[0]
        jsrv.cfg.cache_dtype = dt
        try:
            out = jsrv.serve_continuous(PROMPTS, page_size=ranks.SERVE["page_size"])
        finally:
            jsrv.cfg.cache_dtype = None
        reference[arch, dt] = [list(map(int, o)) for o in out]
    unmeshed = {case: ranks.pool_serve(case[0], params[case[0]], PROMPTS, case[1])
                for case in POOL_CASES}
    meshed = {shape: on_mesh(functools.partial(ranks.pools, POOL_CASES, params, PROMPTS),
                             shape) for shape in SHAPES}
    return reference, unmeshed, meshed


@pytest.mark.parametrize("case", POOL_CASES, ids=_case_id)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_quantized_pool_serves_the_unmeshed_and_reference_tokens(pool_runs, shape, case):
    reference, unmeshed, meshed = pool_runs
    for r in meshed[shape][case]:
        assert r["outcomes"] == ["ok"] * len(PROMPTS)
        assert r["tokens"] == unmeshed[case]["tokens"]
        assert r["stats"]["cache_dtype"] == case[1]
    assert unmeshed[case]["tokens"] == reference[case]


@pytest.mark.parametrize("case", POOL_CASES, ids=_case_id)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_ranks_scales_are_the_unmeshed_pools_for_its_heads(pool_runs, shape, case):
    _, unmeshed, meshed = pool_runs
    want = unmeshed[case]["scales"]
    assert want and all(np.any(s > 0) for s in want.values())
    for r in meshed[shape][case]:
        assert set(r["scales"]) == set(want)
        for key, got in r["scales"].items():
            expect = want[key][..., r["heads"]]  # (..., P, the rank's KV heads)
            assert got.shape == expect.shape, key
            np.testing.assert_array_equal(got > 0, expect > 0, err_msg=key)
            np.testing.assert_allclose(got, expect, rtol=1e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("case", POOL_CASES, ids=_case_id)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_ranks_page_bytes_count_its_heads(pool_runs, shape, case):
    """yi-6b's rank holds half its KV heads; gemma-2b's rank the one head
    its q heads read, as the one device does."""
    _, unmeshed, meshed = pool_runs
    arch, _ = case
    kv = {"yi-6b": 2, "gemma-2b": 1}[arch]
    whole = unmeshed[case]["stats"]["page_hbm_bytes"]
    for r in meshed[shape][case]:
        assert r["stats"]["page_hbm_bytes"] * kv == whole * len(r["heads"])
    if arch == "yi-6b":
        assert meshed[shape][case][0]["stats"]["page_hbm_bytes"] * 2 == whole


# -- (b) int8 weights on a row-parallel product -------------------------------------


@functools.lru_cache(maxsize=None)
def _row_run(shape):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    w[:, 5] = 0.0  # a column of zeros keeps the scale 1.0
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    return w, x, on_mesh(functools.partial(ranks.row_linear, w, x), shape)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_b_row_parallel_codes_and_scales_are_the_unmeshed_ones(shape):
    from repro_torch.nn.blocks import _quantize_int8

    w, _, got = _row_run(shape)
    q, scale = _quantize_int8(torch.from_numpy(w))
    assert len(got) == shape[1]
    for r in got:
        lo, hi = r["rows"]
        np.testing.assert_array_equal(r["q"], q.numpy()[lo:hi])
        np.testing.assert_array_equal(r["scale"], scale.numpy())
        # the scales' max: one all-reduce over model, counted apart from the sums
        assert r["counts"]["all_reduce_max"]["model"]["calls"] == 2
        assert r["counts"]["all_reduce"]["model"]["calls"] == 2


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_b_row_parallel_fp32_product_matches_the_reference(shape):
    import jax.numpy as jnp

    from repro.nn import blocks as jblocks
    from repro.nn.dtypes import DTypePolicy as JDTypePolicy
    from repro_torch.nn.blocks import Linear
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.nn.module import Ctx

    w, x, got = _row_run(shape)
    policy = JDTypePolicy.make("fixed")
    wq, scale = jblocks._quantize_int8(jnp.asarray(w))
    want = np.asarray(jblocks._int8_matmul(jnp.asarray(x, policy.compute_dtype), wq, scale,
                                           policy), np.float32)
    lin = Linear("wo", 128, 48, axes=("mlp", "embed"))
    one = lin({"w": torch.from_numpy(w)}, torch.from_numpy(x),
              ctx=Ctx(policies=PolicyResolver.default("fixed"))).float().numpy()
    for r in got:
        np.testing.assert_allclose(r["y32"], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        # the bf16 output: the fp32 result rounded once, on every rank alike
        np.testing.assert_array_equal(r["y"], got[0]["y"])
        np.testing.assert_allclose(r["y"], one, rtol=1e-2, atol=1e-2 * np.abs(one).max())


@pytest.fixture(scope="module")
def fixed_logits():
    """Reduced yi-6b under `fixed`: the reference's `apply`, the unmeshed
    port and (2, 2)."""
    import jax.numpy as jnp

    from repro.nn.dtypes import PolicyResolver as JPolicies
    from repro.nn.module import Ctx as JCtx

    jsrv, np_params = _reference_server("yi-6b")
    tokens = np.random.default_rng(1).integers(0, 512, (4, 12)).astype(np.int32)
    want, _ = jsrv.woven.program.model(jsrv.params, {"tokens": jnp.asarray(tokens)},
                                       ctx=JCtx(policies=JPolicies.default("fixed")),
                                       mode="dense")
    w = ranks.woven("yi-6b", "serve", {}, policy="fixed")
    with torch.no_grad():
        one, _ = w.program.model(ranks.whole_params(w, np_params),
                                 {"tokens": torch.from_numpy(tokens)},
                                 ctx=w.state.make_ctx(), mode="dense")
    got = on_mesh(functools.partial(ranks.fixed_logits, "yi-6b", np_params, tokens), (2, 2))
    return got, {"reference": np.asarray(want, np.float32), "unmeshed": one.float().numpy()}


@pytest.mark.parametrize("against", ["reference", "unmeshed"])
def test_b_fixed_logits_on_a_2x2_mesh(fixed_logits, against):
    """Within the card's logit gates (`chip_smoke.py`: the largest error
    2e-2 and the RMS error 1e-2 of the logit scale): bf16 activations, their
    products summed in another order on the mesh."""
    got, wants = fixed_logits
    want = wants[against]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    assert np.sqrt(np.mean((got - want) ** 2)) <= 1e-2 * scale


# -- (c) int8 gradient compression -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _train_reference():
    """One-layer reduced qwen2-72b at head_dim 64: the reference's weights
    and its jitted compressed step on one device."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import SHAPES as JSHAPES
    from repro.core.program import Program as JProgram
    from repro.data.pipeline import PipelineConfig, TokenPipeline
    from repro.launch.weave import default_weave as jweave
    from repro.models.registry import build_model as jbuild
    from repro.models.registry import reduced_config as jreduced
    from repro.nn.dtypes import PolicyResolver as JPolicies
    from repro.nn.module import init_params as jinit
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jsched
    from repro.runtime.steps import build_train_step as jbuild_train_step

    from _torch_port import np_tree

    arch, replace = ranks.TRAIN_ARCH
    cfg = jreduced(arch).replace(head_dim=64, **replace)
    model = jbuild(cfg)
    jparams = jinit(model, jax.random.PRNGKey(0), JPolicies.default("f32"))
    np_params = np_tree(jparams)
    jw = jweave(JProgram(model=model, cfg=cfg, kind="train"), JSHAPES["train_4k"], {},
                overrides={"accum_steps": 1, "remat": "full"})
    jw.state.policies = JPolicies.default("f32")
    opt_cfg = jadamw.AdamWConfig(eps=ranks.ADAM_EPS, compression=True)
    jstep = jax.jit(jbuild_train_step(jw, lr_fn=functools.partial(jsched.constant,
                                                                  peak=ranks.LR),
                                      opt_cfg=opt_cfg))
    batch = next(TokenPipeline(PipelineConfig(vocab=512, seq_len=16, global_batch=4)))
    jp, jstate, jm = jstep(jparams, jadamw.init_state(jparams, opt_cfg),
                           jax.tree.map(jnp.asarray, batch), jnp.asarray(0, jnp.int32))
    return np_params, batch, {"metrics": {k: float(v) for k, v in jm.items()},
                              "params": np_tree(jp), "ef": np_tree(jstate["ef"])}


@pytest.fixture(scope="module")
def compressed_runs():
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step

    np_params, batch, reference = _train_reference()
    arch, replace = ranks.TRAIN_ARCH
    tw = ranks.woven(arch, "train", {}, replace=replace)
    tp = ranks.whole_params(tw, np_params)
    opt_cfg = adamw.AdamWConfig(eps=ranks.ADAM_EPS, compression=True)
    tstep = build_train_step(tw, opt_cfg=opt_cfg,
                             lr_fn=lambda s: ranks.schedule.constant(s, peak=ranks.LR))
    tp, tstate, tm = tstep(tp, adamw.init_state(tp, opt_cfg),
                           {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    unmeshed = {"metrics": {k: float(v) for k, v in tm.items()},
                "params": ranks.to_host(tp), "ef": ranks.to_host(tstate["ef"])}
    meshed = on_mesh(functools.partial(ranks.compressed_step, np_params, batch), (2, 2))
    return {"reference": reference, "unmeshed": unmeshed}, meshed


@pytest.mark.parametrize("against", ["reference", "unmeshed"])
def test_c_a_compressed_step_on_a_2x2_mesh_matches(compressed_runs, against):
    wants, meshed = compressed_runs
    want = wants[against]
    for key in ("loss", "grad_norm"):
        assert rel_rms(meshed["metrics"][key], want["metrics"][key]) < REL_TOL, key
    got = dict(_leaves(meshed["params"]))
    for path, w in _leaves(want["params"]):
        assert np.shape(got[path]) == np.shape(w), path
        assert rel_rms(got[path], w) < ZERO_GRAD_TOL.get(path, REL_TOL), path


@pytest.mark.parametrize("against", ["reference", "unmeshed"])
def test_c_the_error_feedback_is_the_one_devices(compressed_runs, against):
    """`ef` leaf by leaf, compressed where the whole leaf is: the residual
    of each element equals the one device's within 1e-3 of its row's
    largest, but for codes that round the other way, on at most 1 % of a
    leaf.  A residual is the gradient less its dequantised code, about
    1/254 of the gradient, so the gradients' relative difference in their
    last bits (summation orders) grows ~250-fold in it (rel RMS ~1e-4); an
    element that lies on a rounding boundary moves by one quantisation step
    (twice the largest residual of its row)."""
    wants, meshed = compressed_runs
    got = dict(_leaves(meshed["ef"]))
    for path, w in _leaves(wants[against]["ef"]):
        if path in ZERO_GRAD_TOL:
            continue
        g = got[path]
        assert g.shape == w.shape, path
        if w.size < 128:
            assert not np.any(g) and not np.any(w), path  # passed through
            continue
        row = np.abs(w).max(axis=-1, keepdims=True)
        off = np.abs(g - w) > 1e-3 * row
        assert off.mean() <= 0.01, (path, off.mean())
        assert np.all(np.abs(g - w) <= 2.5 * row), path


def test_c_a_split_bias_is_compressed_as_its_whole_leaf(compressed_runs):
    """bv holds 128 elements, 64 on a rank: the rule reads the whole leaf,
    so its residual is not the pass-through's zero."""
    _, meshed = compressed_runs
    ef = dict(_leaves(meshed["ef"]))["/blocks0/block/attn/bv"]
    assert ef.size == 128 and np.any(ef != 0)
    shapes = dict(zip([p for p, _ in _leaves(meshed["ef"])], meshed["ef_shapes"][0]))
    assert np.prod(shapes["/blocks0/block/attn/bv"]) == 64


def test_c_ef_is_shaped_as_the_ranks_blocks(compressed_runs):
    _, meshed = compressed_runs
    assert len(meshed["ef_shapes"]) == 4
    assert meshed["ef_shapes"][0] == meshed["param_shapes"]
    for shapes in meshed["ef_shapes"]:
        assert shapes == meshed["ef_shapes"][0]
    # the rows of a leaf split on its last dim: one max all-reduce per such leaf
    assert meshed["counts"]["all_reduce_max"]["model"]["calls"] > 0


LEAF_SPECS = {
    "last_dim_split": ((8, 64), (None, "model")),
    "first_dim_split": ((8, 64), ("model", None)),
    "bias_split_over_both": ((256,), (("data", "model"),)),
    "small_bias_passes": ((96,), ("model",)),
}


@pytest.fixture(scope="module")
def compressed_leaves():
    rng = np.random.default_rng(6)
    names = sorted(LEAF_SPECS)
    leaves = [rng.standard_normal(LEAF_SPECS[n][0]).astype(np.float32) for n in names]
    specs = [LEAF_SPECS[n][1] for n in names]
    got = on_mesh(functools.partial(ranks.compress_leaves, leaves, specs), (2, 2))
    return dict(zip(names, zip(leaves, got)))


@pytest.mark.parametrize("name", sorted(LEAF_SPECS))
def test_c_ef_compress_of_a_split_leaf_is_the_unmeshed_one_bit_for_bit(compressed_leaves,
                                                                       name):
    from repro_torch.optim.compression import ef_compress

    g, (deq, ef, block) = compressed_leaves[name]
    want_deq, want_ef = ef_compress(torch.from_numpy(g), torch.zeros(g.shape))
    np.testing.assert_array_equal(deq, want_deq.numpy())
    np.testing.assert_array_equal(ef, want_ef.numpy())
    assert np.prod(block) < g.size
    assert np.any(ef != 0) == (g.size >= 128)


def test_c_a_meshed_compressed_checkpoint_restores_on_one_device(tmp_path):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.core.strategies.parallelization import CompressionAspect
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    got = on_mesh(functools.partial(ranks.compressed_trainer, str(tmp_path)), (2, 2))
    assert got["compression"]
    arch, replace = ranks.TRAIN_ARCH
    one = Trainer(ranks.woven(arch, "train", {}, replace=replace,
                              aspects=[CompressionAspect()]),
                  TokenPipeline(PipelineConfig(vocab=512, seq_len=16, global_batch=4)),
                  TrainerConfig(ckpt_dir=str(tmp_path), log_every=0))
    assert one.opt_cfg.compression and one.maybe_restore() and one.step == 2
    for name, tree in (("params", one.params), ("ef", one.opt_state["ef"])):
        have = dict(_leaves(ranks.to_host(tree)))
        for path, w in _leaves(got[name]):
            np.testing.assert_array_equal(have[path], w, err_msg=f"{name}{path}")
    assert any(np.any(w != 0) for _, w in _leaves(got["ef"]))


# -- (d) speculative decoding on a live mesh ----------------------------------------

POOLS = [None, "int8"]
FED = np.random.default_rng(5).integers(0, 512, (len(PROMPTS), 3)).astype(np.int32)


@pytest.fixture(scope="module")
def spec_runs():
    np_params = _np_params("yi-6b")
    meshed = on_mesh(functools.partial(ranks.speculative, np_params, PROMPTS, FED), (1, 2))
    return meshed, _unmeshed_spec(np_params)


def _unmeshed_spec(np_params):
    from repro_torch.runtime.server import Server, ServerConfig

    w = ranks.woven("yi-6b", "serve", {})
    srv = Server(w, ServerConfig(**ranks.SERVE), device="cpu",
                 params=ranks.whole_params(w, np_params))
    out = {}
    for dt in POOLS:
        srv.cfg.cache_dtype = dt
        toks = srv.serve_continuous(PROMPTS, draft_len=2)
        out[dt, 2] = {"tokens": [list(map(int, o)) for o in toks],
                      "steps": dict(srv.last_step_counts), "spec": srv.last_spec_stats}
        out[dt, "verify"] = ranks.verify_logits(srv, PROMPTS, FED)
    return out


@pytest.mark.parametrize("dt", POOLS, ids=["fp", "int8"])
def test_d_speculative_is_plain_greedy_on_the_mesh(spec_runs, dt):
    meshed, _ = spec_runs
    plain, spec = meshed[dt, 0], meshed[dt, 2]
    assert plain["outcomes"] == spec["outcomes"] == ["ok"] * len(PROMPTS)
    assert spec["tokens"] == plain["tokens"]
    sp, st = spec["spec"], spec["steps"]
    assert sp["verify_steps"] >= 1 and st["verify"] == sp["verify_steps"]
    assert st["draft"] == sp["draft_steps"] and st["decode"] == sp["decode_steps"]
    n = ranks.SERVE["decode_tokens"]
    assert sp["emitted_spec"] + len(PROMPTS) == n * len(PROMPTS)


@pytest.mark.parametrize("dt", POOLS, ids=["fp", "int8"])
def test_d_speculative_on_the_mesh_is_the_unmeshed_serve(spec_runs, dt):
    meshed, unmeshed = spec_runs
    assert meshed[dt, 2]["tokens"] == unmeshed[dt, 2]["tokens"]
    assert meshed[dt, 2]["steps"] == unmeshed[dt, 2]["steps"]
    ints = ("draft_len", "rounds", "request_rounds", "proposed", "accepted",
            "emitted_spec", "draft_steps", "verify_steps", "decode_steps")
    assert {k: meshed[dt, 2]["spec"][k] for k in ints} == \
        {k: unmeshed[dt, 2]["spec"][k] for k in ints}


@pytest.mark.parametrize("dt", POOLS, ids=["fp", "int8"])
def test_d_the_verify_steps_logits_are_the_unmeshed_ones(spec_runs, dt):
    meshed, unmeshed = spec_runs
    got, want = meshed[dt, "verify"], unmeshed[dt, "verify"]
    assert got.shape == want.shape == (len(PROMPTS), 3, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("where", ["no_mesh", "other_mesh"])
def test_d_a_draft_off_the_targets_mesh_is_refused(spec_runs, where):
    meshed, _ = spec_runs
    assert meshed["refused"][where].startswith("ValueError: a draft server must be on"), \
        meshed["refused"][where]
