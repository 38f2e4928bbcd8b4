"""Step functions: woven program -> prefill / decode functions.

This is where the separation of concerns pays off: the functions below read
*only* the WeaveState (policies, impls, rules, extra) — every knob the
ANTAREX aspects set lands here, and libVC keeps one closure per variant.
PyTorch runs eagerly, so there is nothing to compile: a step is a plain
closure, run under `torch.no_grad()`.  The train and verify steps arrive with
their slices.
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


def build_paged_prefill_step(woven: WovenProgram, *, mesh=None,
                             variant: str | None = None):
    """Prefill straight into a paged KV pool: `cache` carries the per-layer
    `{"pk", "pv"}` pools (and scale sidecars) + the request's block-table
    row, `prefix_len` is how many leading slots are already resident via
    prefix sharing — the model computes and writes only the non-shared
    suffix, in place, so admission's transient memory is O(live tokens),
    never O(max_len)."""
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model

    def paged_prefill_step(params, inputs, cache, prefix_len: int = 0):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="prefill",
                                      cache=cache, prefix_len=prefix_len)
        return logits, new_cache

    return paged_prefill_step


def build_decode_step(woven: WovenProgram, *, mesh=None, variant: str | None = None,
                      rescore: bool = False):
    """The decode step **mutates** the cache it is given: the new tokens'
    K/V and positions are written into the cache tensors in place (where the
    reference donates the buffers), and those tensors come back in the
    returned cache.  Every caller rebinds its cache to the step's output.

    `rescore=True` builds the no-write step (paged caches only): a
    full-prompt prefix hit re-scores its last prompt token — whose K/V
    already sit on shared pool pages — for the first output logits, without
    touching pages other requests still map."""
    program = woven.program
    state = woven.variant_state(variant)
    model = program.model
    extra_kw = {"skip_cache_write": True} if rescore else {}

    def decode_step(params, inputs, cache):
        ctx = state.make_ctx(mesh=mesh)
        with torch.no_grad():
            logits, new_cache = model(params, inputs, ctx=ctx, mode="decode",
                                      cache=cache, **extra_kw)
        return logits, new_cache

    return decode_step


def stack_request_caches(model, caches: list) -> Any:
    """Stack per-request (batch=1) prefill caches into one batched decode
    cache with per-request `index` — the *dense* multi-request serving
    layout: every request pads to the same cache length, so device memory
    scales with batch x max_len.  The paged pool (`runtime/pages.py`)
    replaces it in continuous serving; this stays the reference layout the
    paged path must match bit for bit."""
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
