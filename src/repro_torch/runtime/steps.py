"""Step functions: woven program -> prefill / decode functions.

This is where the separation of concerns pays off: the functions below read
*only* the WeaveState (policies, impls, rules, extra) — every knob the
ANTAREX aspects set lands here, and libVC keeps one closure per variant.
PyTorch runs eagerly, so there is nothing to compile: a step is a plain
closure, run under `torch.no_grad()`.  The train, paged-prefill, re-score and
verify steps arrive with their slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.weaver import WovenProgram


def build_prefill_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                       cache_max_len: int | None = None):
    """`cache_max_len` pins the prefill cache padding on a *copied* weave
    state, without disturbing the shared state the ordinary prefill reads."""
    program = woven.program
    state = woven.variant_state(variant)
    if cache_max_len is not None:
        state = state.copy()
        state.extra["cache_max_len"] = cache_max_len
    model = program.model

    def prefill_step(params, inputs):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, cache = model(params, inputs, ctx=ctx, mode="prefill")
        return logits, cache

    return prefill_step


def build_decode_step(woven: WovenProgram, *, mesh=None, variant: str | None = None):
    """The decode step **mutates** the cache it is given: the new tokens'
    K/V and positions are written into the cache tensors in place (where the
    reference donates the buffers), and those tensors come back in the
    returned cache.  Every caller rebinds its cache to the step's output."""
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model

    def decode_step(params, inputs, cache):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="decode",
                                      cache=cache)
        return logits, new_cache

    return decode_step


def stack_request_caches(model, caches: list) -> Any:
    """Stack per-request (batch=1) prefill caches into one batched decode
    cache with per-request `index` — the *dense* multi-request serving
    layout: every request pads to the same cache length, so device memory
    scales with batch x max_len.  The paged pool replaces this in a later
    slice; this stays the reference layout the paged path must match bit for
    bit."""
    if len(caches) == 1:
        return caches[0]
    return model.stack_caches(caches)


# ---------------------------------------------------------------------------
# Heuristics shared by the launchers
# ---------------------------------------------------------------------------


def default_accum(cfg, shape_kind: str) -> int:
    """Microbatching that bounds live activations/logits in training; serving
    shapes never accumulate."""
    if shape_kind != "train":
        return 1
    if cfg.family in ("ssm", "hybrid"):
        return 1
    n = cfg.param_count()
    if n >= 200e9:
        return 32
    if n >= 50e9:
        return 16
    return 8
