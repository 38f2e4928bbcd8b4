"""Default (paper-faithful baseline) weave for each (arch x shape x mesh).

This is the aspect stack an ANTAREX HPC expert would start from:
auto-parallelization (AutoShard), remat + gradient accumulation, mixed bf16
precision, and monitoring.  Hillclimb variants override
pieces via `overrides` (CLI --set / EXPERIMENTS.md §Perf).
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import BlockSizeAspect, KernelAspect
from repro_torch.core.strategies.parallelization import (
    AccumAspect,
    AutoShard,
    RematAspect,
    ShardingAspect,
)
from repro_torch.core.strategies.precision import ChangePrecision
from repro_torch.core.weaver import Aspect, WovenProgram, weave
from repro_torch.runtime.steps import default_accum


def default_weave(
    program: Program,
    shape: ShapeConfig | str,
    mesh_axes: Mapping[str, int],
    *,
    overrides: Mapping[str, Any] | None = None,
    extra_aspects: list[Aspect] | None = None,
) -> WovenProgram:
    if isinstance(shape, str):
        shape = SHAPES[shape]
    overrides = dict(overrides or {})
    train = shape.kind == "train"

    accum = int(overrides.pop("accum_steps",
                              default_accum(program.cfg, shape.kind)))
    # microbatches must keep every data-parallel rank fed (B_micro >= DP)
    dp = 1
    for a in ("pod", "data"):
        dp *= int(mesh_axes.get(a, 1) or 1)
    if program.cfg.family in ("ssm", "hybrid"):
        dp *= int(mesh_axes.get("model", 1) or 1)
    if train and dp > 1:
        accum = max(1, min(accum, shape.global_batch // dp))
    aspects: list[Aspect] = [
        AutoShard(dict(mesh_axes), train=train),
        RematAspect(str(overrides.pop("remat", "full" if train else "none"))),
        AccumAspect(accum),
    ]
    policy = overrides.pop("precision", None)
    if policy:
        aspects.append(ChangePrecision("*", policy))
    rules_override = overrides.pop("rules", None)
    if rules_override:
        aspects.append(ShardingAspect(rules_override))
    # the reference weaves DSE-tuned blocks here (TunedKernelAspect); the
    # tuner is a later slice, so the flag is accepted and nothing is woven
    overrides.pop("tuned_kernels", None)
    block_sizes = {k: int(v) for k, v in list(overrides.items())
                   if k.startswith(("flash_block", "wkv_chunk"))}
    if block_sizes:
        aspects.append(BlockSizeAspect(**block_sizes))
        for k in block_sizes:
            overrides.pop(k)
    if extra_aspects:
        aspects.extend(extra_aspects)

    woven = weave(program, aspects)
    # remaining overrides land in extra verbatim (opt_state_dtype, moe_capacity_factor...)
    for k, v in overrides.items():
        woven.state.extra[k] = v
    return woven


def cuda_kernel_aspects() -> list[Aspect]:
    """The aspects that put the hand-written CUDA kernels on the attention,
    RMSNorm, RG-LRU and WKV joinpoints — woven on top of `default_weave`
    whenever the program runs on the card (the counterpart of weaving
    `"pallas"`).  The `"norm"` impl is read by `RMSNorm` alone: `LayerNorm`
    and `GroupNorm` stay plain under it, as in the reference."""
    return [KernelAspect("*", "attention", "cuda"),
            KernelAspect("*", "norm", "cuda"),
            KernelAspect("*", "rglru", "cuda"),
            KernelAspect("*", "wkv", "cuda")]


def train_kernel_aspects() -> list[Aspect]:
    """The aspects a training run weaves on the card: the attention kernels
    alone (K1 with its `lse` and the fused backward K3).  RMSNorm, RG-LRU
    and WKV have forward-only kernels, as in the reference, so training
    runs their plain implementations."""
    return [KernelAspect("*", "attention", "cuda")]
