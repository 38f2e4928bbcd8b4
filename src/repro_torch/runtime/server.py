"""Serving runtime: batched prefill+decode with mARGOt QoS adaptation.

This is the UC2 (navigation) runtime shape: requests arrive with a prompt,
the server prefills then decodes N tokens; the woven knobs (precision
variant, decode budget, memoization on/off) are adapted by mARGOt against a
quality index + latency/cost constraints.

This slice holds the dense path: `serve` and `serve_batch`.  The paged pool,
`serve_continuous` and `serve_stream` are the next slice; the `ServerConfig`
fields they read are already here so configurations carry over unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.weaver import WovenProgram
from repro_torch.memo.table import MemoTable
from repro_torch.monitor.examon import ExamonBroker, get_default_broker
from repro_torch.nn.module import init_params, resolve_device
from repro_torch.runtime.steps import (
    build_decode_step,
    build_prefill_step,
    stack_request_caches,
)
from repro_torch.versioning.libvc import LibVC


@dataclasses.dataclass
class ServerConfig:
    max_cache_len: int = 256
    decode_tokens: int = 8
    seed: int = 0
    # paged / continuous-batching serving (serve_continuous)
    page_size: int | None = None   # None: woven knob or 128 default
    pool_pages: int | None = None  # None: sized for full concurrency
    max_batch: int | None = None   # decode-batch cap (admission gate)
    prefix_sharing: bool = True    # map common prompt prefixes onto shared pages
    # speculative decoding (serve_continuous): tokens the draft model
    # proposes per verify round; None/0 falls back to the woven
    # "speculative_draft_len" knob, then to plain one-token decode
    draft_len: int | None = None
    # quantized page pool (serve_continuous): "int8" / "float8_e4m3fn" /
    # "float8_e5m2" stores pk/pv quantized with per-page-per-KV-head scale
    # sidecars; None falls back to the woven "flash_cache_dtype" knob
    cache_dtype: str | None = None
    # resilience (serve_continuous): per-request SLO, bounded retry budget
    # around transient step faults, and pool-audit barriers
    deadline_s: float | None = None
    retries: int | None = None
    pool_audit: bool | None = None
    # QoS-adaptive streaming (serve_stream): tokens of a long admission
    # prefilled per decode wave, and per-request latency SLOs (seconds)
    prefill_chunk: int | None = None
    slo_ttft_s: float | None = None
    slo_tok_s: float | None = None


class Server:
    def __init__(self, woven: WovenProgram, cfg: ServerConfig, *, mesh=None,
                 margot=None, broker: ExamonBroker | None = None,
                 memo: MemoTable | None = None,
                 device: "str | torch.device | None" = None):
        """`device` defaults to the program's (the card unless the program
        was built for the CPU); a card that is absent raises."""
        if mesh is not None:
            raise NotImplementedError(
                "device meshes are not ported yet (a later slice)")
        self.woven = woven
        self.cfg = cfg
        self.device = resolve_device(
            device if device is not None else woven.program.device)
        self.mesh = mesh
        self.margot = margot
        self.broker = broker or get_default_broker()
        self.memo = memo if memo is not None else woven.state.extra.get("memo_table")
        self.info: dict[str, Any] = {"task_name": woven.program.cfg.name, "knobs": {}}

        def build(kind):
            def make_step(variant: str):
                v = None if variant == "__default__" else variant
                if kind == "prefill":
                    return build_prefill_step(self.woven, mesh=self.mesh, variant=v)
                # the decode step updates the cache tensors in place; every
                # caller rebinds the cache to the step's output
                return build_decode_step(self.woven, mesh=self.mesh, variant=v)

            # "fallback" falls back to the default *variant* when a variant's
            # step cannot be made.  Kernels are built at their first launch, not
            # here, so this cannot hide a failed kernel build.
            return LibVC(make_step, error_strategy="fallback")

        self.prefill_vc = build("prefill")
        self.decode_vc = build("decode")
        self.params = init_params(woven.program.model, cfg.seed,
                                  woven.state.policies, self.device)
        self.served = 0
        # latency histories are sliding windows (deques), not unbounded lists
        self.history_window = 4096
        self.latencies: deque[float] = deque(maxlen=self.history_window)

    def _variant(self) -> str | None:
        if self.margot is None:
            return None
        op = self.margot.update()
        self.info["knobs"].update(op.knobs)
        return op.knobs.get("variant") or op.knobs.get("precision_mix")

    def _begin(self) -> str | None:
        variant = self._variant()
        state = self.woven.variant_state(
            None if variant in (None, "__default__") else variant
        )
        state.extra["cache_max_len"] = self.cfg.max_cache_len
        return variant

    def _finish(self, key, result, t0: float, n_requests: int):
        # the result is already on the host, so the device work is done
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        self.served += n_requests
        self.broker.publish("serve/latency/@host0", dt)
        if self.margot is not None:
            self.margot.observe("latency", dt)
        if self.memo is not None:
            self.memo.update(key, result)
        return result

    def serve(self, tokens: np.ndarray, *, decode_tokens: int | None = None) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, N) generated ids (greedy)."""
        n = decode_tokens or self.cfg.decode_tokens
        key = ("serve", tokens.tobytes(), n)
        if self.memo is not None and self.memo.running:
            hit, out = self.memo.lookup(key)
            if hit:
                return out
        t0 = time.perf_counter()
        variant = self._begin()

        toks = torch.as_tensor(np.asarray(tokens), device=self.device).to(torch.int32)
        B, S = toks.shape
        logits, cache = self.prefill_vc(variant, self.params, {"tokens": toks})
        outs = []
        pos = S
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        for _ in range(n):
            outs.append(tok)
            logits, cache = self.decode_vc(
                variant, self.params,
                {"tokens": tok,
                 "positions": torch.full((B, 1), pos, dtype=torch.int32,
                                         device=self.device)},
                cache,
            )
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            pos += 1
        result = torch.cat(outs, dim=1).cpu().numpy()
        return self._finish(key, result, t0, 1)

    def serve_batch(self, prompts: list[np.ndarray], *,
                    decode_tokens: int | None = None) -> list[np.ndarray]:
        """Serve several requests — of *different* prompt lengths — as one
        batched decode: per-request prefill (each at its own length), caches
        stacked with per-request `index`, then a single decode loop at batch
        size B with per-request positions.  This is the layout the
        flash_decode kernel is built for: every request prunes its own live
        cache blocks through the index vector.

        Returns one (decode_tokens,) int array per request; greedy decode,
        equal to serving each request alone wherever the matrix products do
        not depend on the batch size (exactly so on the CPU).
        """
        n = decode_tokens or self.cfg.decode_tokens
        key = ("serve_batch", tuple(np.asarray(p).tobytes() for p in prompts), n)
        if self.memo is not None and self.memo.running:
            hit, out = self.memo.lookup(key)
            if hit:
                return out
        t0 = time.perf_counter()
        variant = self._begin()

        caches, first_toks = [], []
        for p in prompts:
            toks = torch.as_tensor(np.asarray(p), device=self.device) \
                .to(torch.int32).reshape(1, -1)
            logits, cache = self.prefill_vc(variant, self.params,
                                            {"tokens": toks})
            caches.append(cache)
            first_toks.append(torch.argmax(logits[0, -1], dim=-1))
        cache = stack_request_caches(self.woven.program.model, caches)
        del caches

        B = len(prompts)
        pos = torch.tensor([np.asarray(p).reshape(-1).shape[0] for p in prompts],
                           dtype=torch.int32, device=self.device)
        tok = torch.stack(first_toks).reshape(B, 1).to(torch.int32)
        outs = []
        for _ in range(n):
            outs.append(tok)
            logits, cache = self.decode_vc(
                variant, self.params,
                {"tokens": tok, "positions": pos[:, None]},
                cache,
            )
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            pos = pos + 1
        stacked = torch.cat(outs, dim=1).cpu().numpy()
        result = [stacked[b] for b in range(B)]
        return self._finish(key, result, t0, B)
