"""PyTorch port, the roofline (`repro_torch.roofline`) against the
reference's `repro.roofline`: the analytic kernel cores for every full
config and supported shape (exact), the `Roofline` terms on the card's
constants (the reference's `TestRooflineMath` cases at one second per
term), the ring wire accounting against the reference's HLO parser on its
own snippet, and the meta-device count: a linear's FLOPs and bytes (exact),
in-place writes and gathers, the remat recompute with no 8/6 factor, the
analytic cores scaled to the remat woven, the
optimizer's bytes whatever its slice, K1's `bound_ms` from the core, and a
composed card cell.  Tolerances: exact, except `pytest.approx`'s default
(1e-6 relative) on the terms in seconds, which divide by the peaks."""

import math

import pytest
import torch

from repro.models.registry import ARCHS as JARCHS
from repro.models.registry import cells as jcells
from repro.models.registry import get_config as jget
from repro.roofline import analysis as janalysis
from repro.roofline import components as jcomponents
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.program import Program
from repro_torch.launch.mesh import make_card_mesh, make_test_mesh
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import ARCHS, build_model, get_config, reduced_config
from repro_torch.nn.module import abstract_params
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, components
from repro_torch.roofline.hw import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32)

from test_roofline import HLO_SNIPPET

CARD = make_card_mesh("cpu")


def test_card_constants():
    assert (PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, HBM_BW, HBM_BYTES, NVLINK_BW) == (
        989e12, 67e12, 3.35e12, 80e9, 450e9)


# ---------------------------------------------------------------------------
# analytic cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_cores_equal_the_reference(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    cfg, jcfg = get_config(arch), jget(arch)
    windows = {None, cfg.attn_window, cfg.local_window, 1, 4096}
    for shape in jcells(arch):
        S, B = SHAPES[shape].seq_len, SHAPES[shape].global_batch
        for window in windows:
            assert components._causal_context(S, window) == \
                jcomponents._causal_context(S, window)
            for train in (False, True):
                for mask in ("causal", "local", "full"):
                    got = components.attention_core_global(
                        cfg, B, S, train=train, mask=mask, window=window)
                    want = jcomponents.attention_core_global(
                        jcfg, B, S, train=train, mask=mask, window=window)
                    assert got == want
        if cfg.family == "ssm":
            for train in (False, True):
                for chunk in (16, 32, 64):
                    assert components.wkv_core_global(cfg, B, S, train=train, chunk=chunk) \
                        == jcomponents.wkv_core_global(jcfg, B, S, train=train, chunk=chunk)


def test_k1_bound_is_the_attention_core_over_the_peak():
    """`chip_smoke.py`'s K1 bound at B1 S2048 H32 K4 D128 causal: the live
    (q, k) pairs times 4·D·H, over 989 TFLOP/s (0.03476 ms in PERF.md)."""
    cfg = get_config("yi-6b")
    assert (cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim) == (32, 4, 128)
    flops, _ = components.attention_core_global(cfg, 1, 2048, train=False,
                                                mask="causal", window=None)
    pairs = 2048 * 2049 // 2
    assert flops == 4.0 * 128 * pairs * 32 == 3.4376515584e10
    assert flops / PEAK_FLOPS_BF16 * 1e3 == pytest.approx(0.03476, abs=5e-6)


# ---------------------------------------------------------------------------
# Roofline terms: the reference's TestRooflineMath on the card's constants
# ---------------------------------------------------------------------------


def _roof(**kw):
    base = dict(arch="a", shape="s", mesh="m", chips=256,
                flops_per_device=989e12, bytes_per_device=3.35e12,
                collective_bytes_per_device=450e9, collective_counts={},
                collective_by_op={}, model_flops=989e12 * 256 * 0.5,
                memory_per_device={"argument": 0, "output": 0})
    base.update(kw)
    return analysis.Roofline(**base)


def test_terms_are_one_second_each():
    r = _roof()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.step_s == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(0.5)


def test_bottleneck_selection():
    assert _roof(collective_bytes_per_device=4500e9).bottleneck == "collective"
    assert _roof(flops_per_device=989e13).bottleneck == "compute"
    assert _roof(bytes_per_device=3.35e13).bottleneck == "memory"


def test_useful_ratio_and_json_keys():
    r = _roof(model_flops=989e12 * 256)
    assert r.useful_ratio == pytest.approx(1.0)
    j = janalysis.Roofline(
        arch="a", shape="s", mesh="m", chips=256, flops_per_device=1.0,
        bytes_per_device=1.0, collective_bytes_per_device=1.0,
        collective_counts={}, collective_by_op={}, model_flops=1.0,
        memory_per_device={})
    assert list(r.to_json()) == list(j.to_json())
    assert analysis.hbm_per_device(_roof(memory_per_device={
        "argument": 5.0, "output": 2.0})) == 7.0


# ---------------------------------------------------------------------------
# collectives: the ring accounting against the reference's HLO parser
# ---------------------------------------------------------------------------


def test_ring_wire_accounting_equals_the_reference_parser():
    want = janalysis.parse_collectives(HLO_SNIPPET)
    got = analysis.collective_stats([
        ("all-reduce", 1024 * 512 * 4, 4),  # f32, replica group {0,1,2,3}
        ("all-gather", 2048 * 256 * 2, 2),  # bf16, iota groups [2,2]
        ("reduce-scatter", 256 * 128 * 4, 4),
        ("collective-permute", 64 * 64 * 2, 2),  # no groups: the default of 2
    ])
    assert got.counts == want.counts
    assert got.by_op == pytest.approx(want.by_op)
    assert got.wire_bytes == pytest.approx(want.wire_bytes)
    assert got.total_ops() == want.total_ops() == 4
    tup = janalysis.parse_collectives(
        "%t = (f32[128,128]{1,0}, f32[64]{0}) all-reduce(...), "
        "replica_groups={{0,1}}, to_apply=%add")
    size = 128 * 128 * 4 + 64 * 4
    assert analysis.collective_stats([("all-reduce", size, 2)]).wire_bytes == \
        pytest.approx(tup.wire_bytes)
    assert analysis.ring_wire_bytes("all-to-all", 800, 8) == 700
    assert analysis.collective_stats([("all-reduce", 1e9, 1)]).wire_bytes == 0


# ---------------------------------------------------------------------------
# the meta-device count
# ---------------------------------------------------------------------------


def _m(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_count_of_a_linear_is_exact():
    M, N, K = 96, 80, 48
    x, w = _m((M, K)), _m((K, N))
    flops, nbytes = analysis.count_costs(lambda a, b: a @ b, x, w)
    assert flops == 2 * M * N * K
    assert nbytes == (M * K + K * N + M * N) * 2
    # a bias and a batch dim: the same product, the bias read once
    b = _m((N,))
    flops, nbytes = analysis.count_costs(
        lambda a, w_, b_: torch.nn.functional.linear(a, w_.t(), b_), _m((2, M, K)), w, b)
    assert flops == 2 * 2 * M * N * K
    assert nbytes == (2 * M * K + K * N + N + 2 * M * N) * 2
    with pytest.raises(ValueError, match="meta"):
        analysis.count_costs(lambda a: a + 1, torch.zeros(2))


def test_count_reads_gathered_rows_and_writes_the_region_written():
    table, tok = _m((1000, 64)), _m((4, 5), torch.int64)
    _, nbytes = analysis.count_costs(
        lambda e, t_: torch.nn.functional.embedding(t_, e), table, tok)
    assert nbytes == 20 * 64 * 2 + 20 * 8 + 20 * 64 * 2  # rows read, ids, output

    cache, new, idx = _m((8, 100, 4, 16)), _m((8, 1, 4, 16)), _m((), torch.int64)

    def write(c, n, i):
        c[:, i.reshape(1)] = n
        return c  # handed back: its write counts, not the whole cache

    _, nbytes = analysis.count_costs(write, cache, new, idx)
    assert nbytes == 8 * 4 * 16 * 2 * 2 + 8


def _dense_block(arch="yi-6b"):
    cfg = reduced_config(arch)
    program = Program(model=build_model(cfg), cfg=cfg, device=torch.device("meta"))
    woven = default_weave(program, SHAPES["train_4k"], dict(CARD.shape))
    return cfg, program, woven


def test_remat_full_counts_the_recompute_once_with_no_8_6_factor():
    """The traced backward under remat `full` holds the recompute: the
    count is `none`'s plus the forward torch's checkpoint reruns.  It stops
    at the last tensor the backward needs, so the block's last product (the
    MLP's down projection) is not rerun.  The reference's 8/6 would count
    the recompute a second time."""
    cfg, program, woven = _dense_block()
    block = program.model.trunk[0].template
    B, S, d = 2, 32, cfg.d_model
    kw = dict(B=B, S=S, d_model=d)
    none_f, none_b, _, _ = components.block_component(
        block, CARD, woven, mode="dense", train=True, remat="none", **kw)
    full_f, full_b, _, _ = components.block_component(
        block, CARD, woven, mode="dense", train=True, remat="full", **kw)
    fwd_f, _, _, _ = components.block_component(
        block, CARD, woven, mode="prefill", train=False, **kw)
    down = 2 * B * S * cfg.d_ff * d
    assert none_f == 3 * fwd_f  # forward, and the two products of its backward
    assert full_f == none_f + fwd_f - down
    assert full_f != none_f * 8 / 6 and full_f != (none_f + fwd_f) * 8 / 6
    assert full_b == none_b  # the rerun reads what the forward read


def test_analytic_cores_scale_to_the_remat_woven():
    """The cores hold K1's (and K6's) rerun only where the remat reruns it:
    under `none` a training core is 3.5x the forward's FLOPs and 3.0x its
    bytes, under `full`, `dots` and `dots_no_batch` the reference's 4.5x
    and 4.0x.  Pinned through a composed gemma-2b train cell, exact."""
    cfg, B, S = get_config("gemma-2b"), 2, 256
    fwd = components.attention_core_global(cfg, B, S, train=False, mask="causal",
                                           window=cfg.attn_window)
    rerun = components.attention_core_global(cfg, B, S, train=True, mask="causal",
                                             window=cfg.attn_window)
    got = {}
    for remat in ("none", "full"):
        r = components.compose_cell("gemma-2b", ShapeConfig("t", S, B, "train"),
                                    mesh=CARD, verbose=False,
                                    overrides={"remat": remat, "accum_steps": 1})
        got[remat] = next((c["count"], c["flops"], c["bytes"])
                          for c in r["components"] if c["name"] == "attn_core")
    assert got["none"] == (cfg.num_layers, 3.5 * fwd[0], 3.0 * fwd[1])
    assert got["full"] == (cfg.num_layers, *rerun)
    for remat in ("dots", "dots_no_batch"):
        (core,) = components.analytic_cores(cfg, B, S, train=True, remat=remat,
                                            wkv_chunk=32, chips=1)
        assert (core.flops, core.bytes) == rerun
    ssm = get_config("rwkv6-3b")
    fwd = components.wkv_core_global(ssm, B, S, train=False)
    (core,) = components.analytic_cores(ssm, B, S, train=True, remat="none",
                                        wkv_chunk=32, chips=1)
    assert (core.flops, core.bytes) == (3.5 * fwd[0], 3.0 * fwd[1])


def test_optimizer_bytes_whatever_the_slice(monkeypatch):
    """Read: the fp32 gradient sums, master, m, v and the count; written:
    the params (overwritten from master, never read), master, m, v and the
    new count — the same bytes whatever `UPDATE_SLICE` cuts the leaves
    into, and no FLOPs."""
    cfg, program, woven = _dense_block()
    params = abstract_params(program.model, woven.state.policies)
    n = sum(p.numel() for p in analysis.tensors(params))
    p_bytes = sum(p.numel() * p.element_size() for p in analysis.tensors(params))
    got = components.optimizer_component(woven, CARD)
    assert got[0] == 0.0
    assert got[1] == (4 + 3 * 4) * n + 4 + p_bytes + 3 * 4 * n + 4
    monkeypatch.setattr(adamw, "UPDATE_SLICE", 1000)
    assert components.optimizer_component(woven, CARD) == got


def test_compose_cell_on_the_card_mesh():
    """yi-6b decode at B8 over 4096 slots, as the card runs it: the blocks'
    weights and cache and the head, memory-bound; no analytic core at
    decode.  A mesh of more than one device has no composed roofline."""
    r = components.compose_cell("yi-6b", ShapeConfig("r1", 4096, 8, "decode"),
                                mesh=CARD, verbose=False)
    cfg = get_config("yi-6b")
    assert [(c["name"], c["count"]) for c in r["components"]] == [
        ("blocks0", cfg.num_layers), ("outer", 1)]
    assert r["mesh"] == "card_1x1" and r["chips"] == 1
    assert r["bottleneck"] == "memory"
    assert r["step_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
    cache = 2 * 8 * 4096 * cfg.kv_heads * cfg.resolved_head_dim * 2
    block = r["components"][0]
    assert block["bytes"] > cache  # the whole cache is read
    assert r["collective_s"] == 0.0
    assert r["model_flops"] == 6.0 * cfg.active_param_count() * 8 / 3
    with pytest.raises(NotImplementedError, match="SPMD partitioner"):
        components.compose_cell("yi-6b", "decode_32k", mesh=make_test_mesh((2, 2)),
                                verbose=False)
    assert math.isfinite(r["roofline_fraction"])
