"""PyTorch port: the kernel tuner (`repro_torch.autotune.kernel_tuner`) and
`TunedKernelAspect`, held against the reference's on the CPU.

Equal to the reference: the keys of all eight signature functions, the pool
HBM models, the cache format (either package's `TunerCache` reads the
other's bare rows), `refine_from_runtime` on the rows and observations of
`tests/test_kernel_tuner.py::TestRuntimeFeedback`, `tune_quantized_cache` /
`select_cache_knobs` on the cases of `tests/test_quantized_cache.py`, and
`TunedKernelAspect`'s extras from the same rows and its weave report on a
miss.  Inside the port: the spaces hold only knobs that change the launch
on the card, `tune` on a CPU tuner picks a deterministic measure's argmin
and persists every point, `smem_bytes` over the budget excludes a point, a
space with no knob raises, card rows are keyed apart, the shared-memory
model reads the constants of the CUDA sources, and `dkv_n_split` must
divide the group.  Every tuner here uses a caller-supplied measure: the
default one times the kernels on the card and refuses the CPU."""

import dataclasses
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import kernel_tuner as jkt
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import TunedKernelAspect as JAspect
from repro.core.weaver import Weaver as JWeaver
from repro_torch.autotune import kernel_tuner as tkt
from repro_torch.core.program import Program as TProgram
from repro_torch.core.strategies.kernels import TunedKernelAspect as TAspect
from repro_torch.core.weaver import Weaver as TWeaver
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import _resolve_blocks, flash_attention

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    """Both packages' default caches point at files of this test."""
    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path / "ref_default.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "port_default.json"))
    monkeypatch.delenv("REPRO_TUNER_ON_DEVICE", raising=False)


def _grid(space):
    points = [{}]
    for name, values in space.items():
        points = [dict(p, **{name: v}) for p in points for v in values]
    return points


# ---------------------------------------------------------------------------
# Signatures, pool models, cache format
# ---------------------------------------------------------------------------

SIGNATURES = [
    ("flash_signature", ((2, 256, 8, 64), 2), dict(causal=True)),
    ("flash_signature", ((1, 512, 4, 128), 4), dict(causal=False, window=64)),
    ("flash_decode_signature", (2, 1024, 8, 2, 64), dict(window=256)),
    ("paged_decode_signature", (8, 4096, 32, 4, 128), {}),
    ("quantized_cache_signature", (2, 256, 4, 2, 64), {}),
    ("speculative_signature", (8, 4096, 32, 4, 128), {}),
    ("rmsnorm_signature", (48, 128), {}),
    ("rwkv6_signature", (2, 128, 256, 64), {}),
    ("rglru_signature", (2, 128, 256), {}),
]


@pytest.mark.parametrize("make,args,kw", SIGNATURES,
                         ids=[f"{b}-{i}" for i, (b, _, _) in enumerate(SIGNATURES)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_signature_keys_equal_reference(make, args, kw, dtype):
    """The same key from a torch dtype, a jnp dtype and the name."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = getattr(jkt, make)(*args, jnp.dtype(jdt), **kw).key()
    assert getattr(tkt, make)(*args, tdt, **kw).key() == want
    assert getattr(tkt, make)(*args, dtype, **kw).key() == want


@pytest.mark.parametrize("page_size,prefix_len", [(64, 512), (512, 512), (64, 511),
                                                  (512, 511), (128, None), (256, 3000)])
def test_prefix_shared_pool_bytes_equal_reference(page_size, prefix_len):
    for dt in ("float32", "bfloat16"):
        jsig = jkt.paged_decode_signature(4, 1024, 8, 2, 64, dt)
        tsig = tkt.paged_decode_signature(4, 1024, 8, 2, 64, dt)
        knobs = {"page_size": page_size}
        assert tkt.prefix_shared_pool_bytes(tsig, knobs, prefix_len=prefix_len) == \
            jkt.prefix_shared_pool_bytes(jsig, knobs, prefix_len=prefix_len)


@pytest.mark.parametrize("cache_dtype", ["float16", "int8", "float8_e4m3fn", "bfloat16"])
def test_quantized_pool_bytes_equal_reference(cache_dtype):
    for ps in (64, 128, 512):
        for T in (256, 1000):
            jsig = jkt.quantized_cache_signature(2, T, 4, 2, 64, "float32")
            tsig = tkt.quantized_cache_signature(2, T, 4, 2, 64, "float32")
            knobs = {"cache_dtype": cache_dtype, "page_size": ps}
            assert tkt.quantized_pool_bytes(tsig, knobs) == \
                jkt.quantized_pool_bytes(jsig, knobs)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_entries_read_across_packages(tmp_path, writer):
    """A bare (interpret / CPU) row written by either package's tuner reads
    in the other: same key, same JSON layout."""
    path = str(tmp_path / "shared.json")
    jsig = jkt.paged_decode_signature(2, 512, 4, 2, 64, "float32")
    tsig = tkt.paged_decode_signature(2, 512, 4, 2, 64, "float32")
    measure = lambda **kn: 1.0 + abs(kn["page_size"] - 128)  # noqa: E731
    if writer == "reference":
        best = jkt.KernelTuner(path).tune(jsig, measure)
        got = tkt.KernelTuner(path, device="cpu").lookup(tsig)
        assert tkt.KernelTuner(path, device="cpu").knowledge_base(tsig) is not None
    else:
        best = tkt.KernelTuner(path, device="cpu").tune(tsig, measure)
        got = jkt.KernelTuner(path).lookup(jsig)
        assert len(jkt.KernelTuner(path).knowledge_base(jsig)) == len(
            json.load(open(path))[tsig.key()]["ops"])
    assert got == best and got["page_size"] == 128


def test_corrupt_cache_file_is_ignored(tmp_path):
    path = tmp_path / "tuner.json"
    sig = tkt.paged_decode_signature(2, 512, 4, 2, 64)
    path.write_text(json.dumps({sig.key(): {"metrics": {}}}))  # an entry without knobs
    assert tkt.KernelTuner(str(path), device="cpu").lookup(sig) is None
    path.write_text("[1, 2]")  # JSON, but not a cache
    assert tkt.KernelTuner(str(path), device="cpu").lookup(sig) is None
    path.write_text("{not json")
    tuner = tkt.KernelTuner(str(path), device="cpu")
    assert tuner.lookup(sig) is None
    tuner.tune(sig, lambda **kn: 1.0)
    assert tkt.KernelTuner(str(path), device="cpu").lookup(sig) == {"page_size": 64}


# ---------------------------------------------------------------------------
# The card's spaces
# ---------------------------------------------------------------------------

SPACES = [
    ("flash_attention", "bfloat16", {"dkv_n_split": [1, 2, 4]}),
    ("flash_attention", "float32", {"block_q": [16, 32, 64], "block_kv": [16, 32, 64],
                                    "block_q_bwd": [16, 32, 64], "block_kv_bwd": [16, 32]}),
    ("flash_decode", "bfloat16", {}),
    ("flash_decode", "float32", {"block_kv_dec": [16, 32, 64]}),
    ("paged_decode", "bfloat16", {"page_size": [64, 128, 256]}),
    ("paged_decode", "float32", {"page_size": [64, 128, 256], "block_kv_dec": [16, 32, 64]}),
    ("quantized_cache", "bfloat16", {"cache_dtype": ["float16", "int8", "float8_e4m3fn"],
                                     "page_size": [64, 128, 256]}),
    ("speculative", "bfloat16", {"draft_len": [1, 2, 4, 8]}),
    ("speculative", "float32", {"draft_len": [1, 2, 4, 8], "block_kv_dec": [16, 32, 64]}),
]


def _tsig(kernel, dtype, T=256):
    if kernel == "flash_attention":
        return tkt.flash_signature((1, T, 4, 64), 1, dtype, causal=True)
    return getattr(tkt, {"flash_decode": "flash_decode_signature",
                         "paged_decode": "paged_decode_signature",
                         "quantized_cache": "quantized_cache_signature",
                         "speculative": "speculative_signature"}[kernel])(
        2, T, 8, 2, 64, dtype)


@pytest.mark.parametrize("kernel,dtype,want", SPACES,
                         ids=[f"{k}-{d}" for k, d, _ in SPACES])
def test_design_space_holds_the_knobs_that_change_the_launch(kernel, dtype, want):
    """bf16 takes the tensor-core routes (fixed tiles: the group split, the
    pool geometry and dtype and the verify width remain), fp32 the FMA
    bodies (their blocks too); the page sizes stop at the cache length."""
    assert tkt.design_space(_tsig(kernel, dtype)) == want
    assert tkt.tunable(_tsig(kernel, dtype)) == bool(want)


def test_reference_block_knobs_leave_the_tensor_core_launch_unchanged():
    """Why bf16 has no block knob: every requested block maps onto the
    compiled-in tiles, and the split route's chunk is a constant."""
    for bq, bkv in ((128, 128), (512, 1024), (16, 32)):
        assert fa_kernel.route_blocks("tc", bq, bkv) == (fa_kernel.TC_BLOCK_Q,
                                                         fa_kernel.TC_BLOCK_KV)
        assert fa_kernel.route_blocks("tc", bq, bkv, backward=True) == (
            fa_kernel.TC_BLOCK_Q_BWD, fa_kernel.TC_BLOCK_KV_BWD)
    assert "SPLIT_CHUNK" in tkt.FIXED_TILES["flash_decode"]


@pytest.mark.parametrize("sig,fixed", [
    (tkt.flash_decode_signature(2, 512, 8, 2, 64, "bfloat16"), "SPLIT_CHUNK"),
    (tkt.rwkv6_signature(2, 128, 256, 64), "wkv6"),
    (tkt.rglru_signature(2, 128, 256), "rglru"),
    (tkt.rmsnorm_signature(64, 128), "rmsnorm"),
], ids=["flash_decode-bf16", "rwkv6", "rglru", "rmsnorm"])
def test_space_without_a_knob_raises_and_always_misses(tmp_path, sig, fixed):
    path = str(tmp_path / "t.json")
    tuner = tkt.KernelTuner(path, device="cpu")
    with pytest.raises(ValueError, match=fixed):
        tuner.tune(sig, lambda **kn: 1.0)
    tuner.cache.put(sig.key(), {"knobs": {"chunk": 64}, "metrics": {}, "ops": []})
    assert tuner.lookup(sig) is None


@pytest.mark.parametrize("kernel,dtype", [(k, d) for k, d, w in SPACES if w],
                         ids=[f"{k}-{d}" for k, d, w in SPACES if w])
def test_tune_picks_the_measures_argmin_and_persists_every_point(tmp_path, kernel, dtype):
    sig = _tsig(kernel, dtype)
    space = tkt.design_space(sig)
    points = _grid(space)
    rng = np.random.default_rng(len(points))
    cost = {json.dumps(p, sort_keys=True): float(c)
            for p, c in zip(points, rng.permutation(len(points)) + 1.0)}
    tuner = tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu")
    best = tuner.tune(sig, lambda **kn: cost[json.dumps(kn, sort_keys=True)])
    assert best == min(points, key=lambda p: cost[json.dumps(p, sort_keys=True)])
    entry = json.load(open(tmp_path / "t.json"))[sig.key()]  # bare key: a CPU tuner
    assert entry["device"] == "cpu" and len(entry["ops"]) == len(points)
    for row in entry["ops"]:
        assert row["metrics"]["smem_bytes"][0] == tkt.config_smem_bytes(sig, row["knobs"])
    if kernel == "paged_decode":
        assert all("pool_hbm_bytes" in r["metrics"] for r in entry["ops"])
    if kernel == "speculative":  # the acceptance-1 prior
        assert all(r["metrics"]["tokens_per_step"][0] == r["knobs"]["draft_len"] + 1
                   for r in entry["ops"])


def test_smem_over_the_budget_excludes_a_point(tmp_path):
    """A code pool's split route requests more shared memory than the bf16
    pool's; under a budget between the two the fp arm wins, though the
    measure prefers the codes."""
    sig = tkt.quantized_cache_signature(8, 4096, 32, 4, 128, "bfloat16")
    values = tkt.config_smem_bytes(sig, {"cache_dtype": "float16"})
    codes = tkt.config_smem_bytes(sig, {"cache_dtype": "int8"})
    assert codes > values
    tuner = tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu", smem_budget=values)
    best = tuner.tune(sig, lambda **kn: 1.0 if kn["cache_dtype"] == "float16" else 0.5)
    assert best["cache_dtype"] == "float16"
    assert tkt.design_space(sig, smem_budget=values)["cache_dtype"] == ["float16"]


def _constants(*files):
    out = {}
    for name in files:
        for m in re.finditer(r"constexpr int (k\w+) = (\d+);", (CSRC / name).read_text()):
            out[m.group(1)] = int(m.group(2))
    return out


def test_smem_model_reads_the_constants_of_the_sources():
    c = _constants("attend_core.cuh", "attend_tc.cuh", "decode_split.cuh", "flash_bwd.cu",
                   "flash_prefill.cu", "flash_decode.cu")
    assert (c["kTcQ"], c["kTcKV"]) == (fa_kernel.TC_BLOCK_Q, fa_kernel.TC_BLOCK_KV)
    assert (c["kTcBwdQ"], c["kTcBwdKV"]) == (fa_kernel.TC_BLOCK_Q_BWD,
                                             fa_kernel.TC_BLOCK_KV_BWD)
    assert (c["kBKV"], c["kPrefillRT"], c["kDecodeRT"]) == (
        fa_kernel.MAX_BLOCK_KV, tkt._FMA_PREFILL_ROWS, tkt._FMA_DECODE_ROWS)
    assert (c["kDqRows"], c["kDqKV"], c["kDkvRows"], c["kDkvQ"]) == (64, 32, 32, 64)
    # the FMA route's knob values stay within the capacities the sources check
    assert max(tkt.FMA_BLOCKS) <= min(fa_kernel.MAX_BLOCK_Q, fa_kernel.MAX_BLOCK_KV,
                                      fa_kernel.MAX_BLOCK_Q_BWD, c["kPrefillRT"], c["kBKV"])
    assert max(tkt.FMA_BLOCKS_KV_BWD) <= min(fa_kernel.MAX_BLOCK_KV_BWD, c["kDqKV"],
                                             c["kDkvRows"])
    assert (c["kSplitRows"], c["kSplitWarps"], c["kSplitStages"], c["kSplitStep"]) == (
        tkt.SPLIT_ROWS, tkt.SPLIT_WARPS, 2, 2048)
    # the sizes the sources' comments state: K1's tensor-core forward 160 KB at
    # head_dim 256, the FMA backward 202 / 210 KB (kernel.py)
    fa = tkt.flash_signature((2, 1024, 8, 256), 1, "bfloat16", causal=True)
    assert tkt._tc_smem(256) == 160 * 1024
    assert tkt.config_smem_bytes(fa, {}) == tkt._tc_bwd_smem(256) <= tkt.DEFAULT_SMEM_BUDGET
    assert round(tkt._fma_bwd_smem(256) / 1024) == 210


def test_card_tuner_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    sig = tkt.paged_decode_signature(2, 512, 4, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkt.KernelTuner(str(tmp_path / "t.json")).tune(sig, lambda **kn: 1.0)
    with pytest.raises(RuntimeError, match="on the card"):
        tkt.default_measure(sig, "cpu")
    with pytest.raises(RuntimeError, match="card"):
        tkt.tune_quantized_cache(tkt.quantized_cache_signature(2, 256, 4, 2, 64),
                                 tuner=tkt.KernelTuner(str(tmp_path / "q.json"),
                                                       device="cpu"))


def test_card_rows_are_keyed_apart_and_memoised(tmp_path, monkeypatch):
    """`<sig>@cuda` rows serve only CUDA lookups; the hot path memoises per
    call and device, and a write clears the memo."""
    path = str(tmp_path / "dev.json")
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", path)
    sig = tkt.paged_decode_signature(2, 512, 4, 2, 64, "float32")
    card = tkt.KernelTuner(path)  # the default device: the card
    card.cache.put(f"{sig.key()}@cuda", {"knobs": {"page_size": 256, "block_kv_dec": 32},
                                          "metrics": {}, "ops": []})
    assert card.lookup(sig) == {"page_size": 256, "block_kv_dec": 32}
    assert tkt.KernelTuner(path, device="cpu").lookup(sig) is None
    q_shape = (2, 1, 4, 64)
    assert tkt.tuned_paged_blocks(q_shape, 512, 2, torch.float32, device="cpu") == {}
    got = tkt.tuned_paged_blocks(q_shape, 512, 2, torch.float32, device="cuda")
    assert got["page_size"] == 256
    default = tkt.default_tuner()
    reads = default.cache.hits + default.cache.misses
    tkt.tuned_paged_blocks(q_shape, 512, 2, torch.float32, device="cuda")
    assert default.cache.hits + default.cache.misses == reads  # a memo read
    default.cache.put(sig.key(), {"knobs": {"page_size": 64}, "metrics": {}, "ops": []})
    assert tkt.tuned_paged_blocks(q_shape, 512, 2, torch.float32, device="cpu") == \
        {"page_size": 64}


# ---------------------------------------------------------------------------
# Runtime feedback and the quantized-cache DSE against the reference
# ---------------------------------------------------------------------------


def _seed_feedback(path, kt, sig, constraint):
    """The rows of `TestRuntimeFeedback._seed_entry`, each package with its
    own constraint column: latency grows with page_size."""
    tuner = kt.KernelTuner(path) if kt is jkt else kt.KernelTuner(path, device="cpu")
    ops = []
    for ps, lat in ((64, 0.4e-3), (128, 0.6e-3), (256, 0.9e-3)):
        knobs = {"page_size": ps, "block_kv_dec": 256}
        ops.append({"knobs": knobs, "metrics": {
            "latency_s": [lat, 1e-5], constraint: [float(64 * ps), 0.0]}})
    tuner.cache.put(sig.key(), {"knobs": dict(ops[-1]["knobs"]),
                                "metrics": dict(ops[-1]["metrics"]), "ops": ops})
    return tuner


FEEDBACK = {
    "accurate_then_drifted": [(0.9e-3, 1.0e-3), (1.8e-3, 1.0e-3)],
    "compounds": [(1.8e-3, 1.0e-3), (0.8e-3, 1.0e-3)],
    "faster_than_expected": [(0.3e-3, 0.5e-3)],
    "no_budget": [(2.0e-3, None)],
}


@pytest.mark.parametrize("case", list(FEEDBACK))
def test_refine_from_runtime_equals_reference(tmp_path, case):
    jsig = jkt.paged_decode_signature(2, 1024, 8, 2, 64)
    tsig = tkt.paged_decode_signature(2, 1024, 8, 2, 64)
    jt = _seed_feedback(str(tmp_path / "j.json"), jkt, jsig, "vmem_bytes")
    tt = _seed_feedback(str(tmp_path / "t.json"), tkt, tsig, "smem_bytes")
    for observed, budget in FEEDBACK[case]:
        want = jkt.refine_from_runtime(jsig, {"latency_s": observed}, tuner=jt,
                                       latency_budget=budget)
        got = tkt.refine_from_runtime(tsig, {"latency_s": observed}, tuner=tt,
                                      latency_budget=budget)
        assert got == want
        je = json.load(open(tmp_path / "j.json"))[jsig.key()]
        te = json.load(open(tmp_path / "t.json"))[tsig.key()]
        assert te["runtime"] == je["runtime"]
        assert [r["metrics"]["latency_s"] for r in te["ops"]] == \
            [r["metrics"]["latency_s"] for r in je["ops"]]
    assert tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu").lookup(tsig) == \
        jkt.KernelTuner(str(tmp_path / "j.json")).lookup(jsig)


def test_refine_never_tuned_returns_none(tmp_path):
    sig = tkt.paged_decode_signature(2, 1024, 8, 2, 64)
    assert tkt.refine_from_runtime(sig, {"latency_s": 1e-3}, latency_budget=1e-3,
                                   tuner=tkt.KernelTuner(str(tmp_path / "c.json"),
                                                         device="cpu")) is None
    assert jkt.refine_from_runtime(jkt.paged_decode_signature(2, 1024, 8, 2, 64),
                                   {"latency_s": 1e-3}, latency_budget=1e-3,
                                   tuner=jkt.KernelTuner(str(tmp_path / "r.json"))) is None


QUANT_CASES = {
    "int8_wins_capacity": ({"int8": 0.02, "float8_e4m3fn": 0.2, "float8_e5m2": 0.2}, 0.05),
    "fp8_within_budget": ({"int8": 0.04, "float8_e4m3fn": 0.01}, 0.02),
    "nothing_quantized_fits": ({"int8": 0.5, "float8_e4m3fn": 0.5}, 0.05),
}


def _quant_tune(tmp_path, kt, err, budget):
    path = str(tmp_path / ("j.json" if kt is jkt else "t.json"))
    tuner = kt.KernelTuner(path) if kt is jkt else kt.KernelTuner(path, device="cpu")
    sig = kt.quantized_cache_signature(2, 256, 4, 2, 64, "float32")
    knobs = kt.tune_quantized_cache(
        sig, error_budget=budget, tuner=tuner, measure=lambda **kn: 1.0,
        error_measure=lambda **kn: err.get(str(kn["cache_dtype"]), 0.0))
    return tuner, sig, knobs


def _pool_knobs(knobs):
    return {k: knobs[k] for k in ("cache_dtype", "page_size")}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantized_cache_dse_equals_reference(tmp_path, case):
    err, budget = QUANT_CASES[case]
    jt, jsig, want = _quant_tune(tmp_path, jkt, err, budget)
    tt, tsig, got = _quant_tune(tmp_path, tkt, err, budget)
    assert _pool_knobs(got) == _pool_knobs(want)
    entry = tt.cache.get(tt._key(tsig))
    assert entry["error_budget"] == budget and entry["device"] == "cpu"
    assert all("max_logit_err" in r["metrics"] and "tokens_per_hbm_byte" in r["metrics"]
               for r in entry["ops"])


def test_select_cache_knobs_equals_reference(tmp_path):
    """A tightened budget forces the fp arm, the old one brings int8 back;
    an untuned signature selects nothing."""
    err = {"int8": 0.02, "float8_e4m3fn": 0.2}
    jt, jsig, _ = _quant_tune(tmp_path, jkt, err, 0.05)
    tt, tsig, _ = _quant_tune(tmp_path, tkt, err, 0.05)
    for budget, arm in ((1e-6, "float16"), (0.05, "int8")):
        want = jkt.select_cache_knobs(jsig, error_budget=budget, tuner=jt)
        got = tkt.select_cache_knobs(tsig, error_budget=budget, tuner=tt)
        assert _pool_knobs(got) == _pool_knobs(want) and got["cache_dtype"] == arm
        assert tt.cache.get(tt._key(tsig))["error_budget"] == budget
    other = tkt.quantized_cache_signature(4, 256, 4, 2, 64, "float32")
    assert tkt.select_cache_knobs(other, error_budget=0.05, tuner=tt) is None


def test_refinement_keeps_the_categorical_knob_as_reference(tmp_path):
    err = {"int8": 0.02}
    jt, jsig, _ = _quant_tune(tmp_path, jkt, err, 0.05)
    tt, tsig, _ = _quant_tune(tmp_path, tkt, err, 0.05)
    want = jkt.refine_from_runtime(jsig, {"latency_s": 2.0}, tuner=jt)
    got = tkt.refine_from_runtime(tsig, {"latency_s": 2.0}, tuner=tt)
    assert isinstance(got["cache_dtype"], str) and _pool_knobs(got) == _pool_knobs(want)
    entry = tt.cache.get(tt._key(tsig))
    assert entry["error_budget"] == 0.05 and entry["runtime"]["error_coef"] == \
        jt.cache.get(jt._key(jsig))["runtime"]["error_coef"]


# ---------------------------------------------------------------------------
# TunedKernelAspect
# ---------------------------------------------------------------------------

ROWS = {  # valid on the FMA route of the port and in the reference's spaces
    "flash_attention": {"block_q": 32, "block_kv": 32, "block_q_bwd": 64,
                        "block_kv_bwd": 16},
    "flash_decode": {"block_kv_dec": 32},
    "paged_decode": {"page_size": 256, "block_kv_dec": 16},
    "quantized_cache": {"cache_dtype": "int8", "page_size": 128, "block_kv_dec": 32},
    "speculative": {"draft_len": 2, "block_kv_dec": 64},
}
SIG_OF = {"flash_attention": "signature", "flash_decode": "decode_signature",
          "paged_decode": "paged_signature", "quantized_cache": "quantized_signature",
          "speculative": "speculative_signature"}


def _weave_both(tmp_path, arch, rows, dtype="float32"):
    """Weave the aspect in both packages over caches holding `rows` (bare
    keys: the CPU program's device)."""
    jprog = JProgram.from_arch(arch, reduced=True)
    tprog = TProgram.from_arch(arch, reduced=True, device="cpu")
    ja = JAspect(2, 256, dtype=dtype, cache_len=512,
                 tuner=jkt.KernelTuner(str(tmp_path / "j.json")))
    ta = TAspect(2, 256, dtype=dtype, cache_len=512,
                 tuner=tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu"))
    for kernel, knobs in rows.items():
        for aspect, prog, tuner in ((ja, jprog, ja.tuner), (ta, tprog, ta.tuner)):
            sig = getattr(aspect, SIG_OF[kernel])(prog.cfg)
            tuner.cache.put(sig.key(), {"knobs": dict(knobs), "metrics": {}, "ops": []})
    return JWeaver(jprog).weave([ja]), TWeaver(tprog).weave([ta])


def _tuned(woven):
    keys = ("flash_block", "flash_page_size", "flash_cache_dtype", "speculative_draft_len",
            "flash_dkv_n_split", "wkv_chunk", "rglru_", "rms_block_rows")
    extras = {k: v for k, v in woven.state.extra.items() if k.startswith(keys)}
    knobs = {k: v for k, v in woven.knobs.defaults().items() if k.startswith(keys)}
    return extras, knobs


@pytest.mark.parametrize("rows", [[k] for k in ROWS] + [list(ROWS)],
                         ids=list(ROWS) + ["all"])
def test_tuned_aspect_weaves_the_reference_extras(tmp_path, rows):
    jw, tw = _weave_both(tmp_path, "gemma-2b", {k: ROWS[k] for k in rows})
    extras, knobs = _tuned(tw)
    assert (extras, knobs) == _tuned(jw) and extras
    assert extras == knobs


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-3b", "recurrentgemma-2b"])
def test_tuned_aspect_miss_report_equals_reference(tmp_path, arch):
    jw, tw = _weave_both(tmp_path, arch, {}, dtype="bfloat16")
    assert [dataclasses.astuple(m) for m in tw.report.per_aspect] == \
        [dataclasses.astuple(m) for m in jw.report.per_aspect]
    assert _tuned(tw) == _tuned(jw) == ({}, {})


def test_tuned_aspect_weaves_the_card_only_knobs(tmp_path):
    """bf16: the group split is woven and exposed over the group's
    divisors; the fixed kernels' rows (WKV here) are never read."""
    tprog = TProgram.from_arch("rwkv6-3b", reduced=True, device="cpu")
    tuner = tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu")
    aspect = TAspect(2, 128, dtype="float32", tuner=tuner)
    tuner.cache.put(aspect.rwkv_signature(tprog.cfg).key(),
                    {"knobs": {"chunk": 64}, "metrics": {}, "ops": []})
    assert "wkv_chunk" not in TWeaver(tprog).weave([aspect]).state.extra

    gprog = TProgram.from_arch("gemma-2b", reduced=True, device="cpu")
    aspect = TAspect(2, 256, tuner=tuner)
    sig = aspect.signature(gprog.cfg)
    tuner.cache.put(sig.key(), {"knobs": {"dkv_n_split": 2}, "metrics": {}, "ops": []})
    woven = TWeaver(gprog).weave([aspect])
    assert woven.state.extra["flash_dkv_n_split"] == 2
    G = sig.gqa
    assert woven.knobs["flash_dkv_n_split"].values == tuple(
        n for n in range(1, G + 1) if G % n == 0)


def test_tuned_aspect_reads_the_rows_of_the_programs_device(tmp_path, monkeypatch):
    """A card program reads `@cuda` rows only (built here without a card,
    the device check stood in for: the weave itself touches no tensor)."""
    from repro_torch.core import program as program_mod

    prog = TProgram.from_arch("gemma-2b", reduced=True, device="cpu")
    tuner = tkt.KernelTuner(str(tmp_path / "t.json"), device="cpu")
    aspect = TAspect(2, 256, dtype="float32", cache_len=512, tuner=tuner)
    sig = aspect.paged_signature(prog.cfg)
    tuner.cache.put(f"{sig.key()}@cuda", {"knobs": {"page_size": 512}, "metrics": {},
                                          "ops": []})
    assert "flash_page_size" not in TWeaver(prog).weave([aspect]).state.extra
    monkeypatch.setattr(program_mod, "resolve_device", torch.device)
    card = dataclasses.replace(prog, device=torch.device("cuda"))
    assert TWeaver(card).weave([aspect]).state.extra["flash_page_size"] == 512


def test_default_weave_weaves_the_aspect():
    from repro_torch.launch.weave import default_weave

    prog = TProgram.from_arch("gemma-2b", kind="serve", reduced=True, device="cpu")
    names = [m.name for m in default_weave(prog, "prefill_32k", {}).report.per_aspect]
    assert "TunedKernelBlocks" in names
    off = default_weave(prog, "prefill_32k", {}, overrides={"tuned_kernels": False})
    assert "TunedKernelBlocks" not in [m.name for m in off.report.per_aspect]


# ---------------------------------------------------------------------------
# dkv_n_split threaded to K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_split", [0, 3, 5])
def test_dkv_n_split_must_divide_the_group(n_split):
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="must divide the group 4"):
        flash_attention(q, kv, kv, dkv_n_split=n_split)
    with pytest.raises(ValueError, match="must divide the group"):
        fa_kernel.check_n_split(n_split, 4)


def test_dkv_n_split_reaches_the_backward_and_the_plain_version_ignores_it(tmp_path,
                                                                           monkeypatch):
    """A woven or tuned split reaches `flash_attention_bwd`; on the CPU the
    plain backward gives the same gradient whatever it is."""
    from repro_torch.kernels.flash_attention import ops

    seen = []
    real = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a, **kw: seen.append(kw["n_split"]) or real(*a, **kw))
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(s) for s in ((1, 16, 4, 64), (1, 16, 1, 64),
                                               (1, 16, 1, 64))]
    grads = []
    for split in (None, 1, 2, 4):
        q, k, v = (torch.tensor(x, dtype=torch.float32, requires_grad=True)
                   for x in inputs)
        flash_attention(q, k, v, dkv_n_split=split).sum().backward()
        grads.append([t.grad for t in (q, k, v)])
    assert seen == [None, 1, 2, 4]
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))
    path = str(tmp_path / "hot.json")
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", path)
    sig = tkt.flash_signature((1, 16, 4, 64), 1, torch.float32, causal=True)
    tkt.KernelTuner(path, device="cpu").cache.put(
        sig.key(), {"knobs": {"block_q": 16, "block_kv": 32, "block_kv_bwd": 16},
                    "metrics": {}, "ops": []})
    q = torch.zeros((1, 16, 4, 64))
    kv = torch.zeros((1, 16, 1, 64))
    assert _resolve_blocks(q, kv, causal=True, window=None, block_q=None, block_kv=None,
                           block_q_bwd=None, block_kv_bwd=None, dkv_n_split=None) == \
        (16, 32, 16, 16, None)
    assert _resolve_blocks(q, kv, causal=True, window=None, block_q=64, block_kv=None,
                           block_q_bwd=None, block_kv_bwd=None, dkv_n_split=2) == \
        (64, 32, 64, 16, 2)
