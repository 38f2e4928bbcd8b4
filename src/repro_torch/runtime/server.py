"""Serving runtime: batched prefill+decode with mARGOt QoS adaptation.

This is the UC2 (navigation) runtime shape: requests arrive with a prompt,
the server prefills then decodes N tokens; the woven knobs (precision
variant, decode budget, memoization on/off) are adapted by mARGOt against a
quality index + latency/cost constraints.

Two serving paths:
  - the dense one, `serve` and `serve_batch`: per-request prefill into a
    dense cache, one decode loop over the stacked caches;
  - the main path, `serve_stream` and its wrapper `serve_continuous`:
    continuous batching over a paged KV pool (`runtime/pages.py`) with
    prefix sharing, copy-on-write pages, chunked prefill, an optional
    int8 / fp8 pool (`cache_dtype`), speculative decoding (a draft model's
    proposals scored by one widened-q verify step, the rejected tail rolled
    back) and the woven resilience layer (fault join points, retries,
    quarantine, deadlines, pool audits, graceful drain) and the QoS
    governor (`runtime/qos.QoSGovernor`: mARGOt re-selects max_batch,
    prefill chunk, draft length and the modeled DVFS point as load shifts,
    against TTFT / inter-token SLOs and a power budget).

On a live mesh (`launch/mesh.make_mesh`, Megatron's layout: the dense,
MoE, encoder-decoder and VLM families) every rank runs the same server
over its shards of the weights and of the KV heads (its page pool — a
sliding window's ring pool too — and an encoder-decoder's cross caches
hold its local heads; an image prefix and the encoder's frames are
replicated): the steps hand back whole logits, and
every host decision — the sampled tokens, mARGOt's knobs, memo hits,
deadline sweeps, the tuned kernel knobs — is rank 0's, broadcast, so the
ranks schedule alike and meet in every collective.  Under `dp_fsdp` (the
recurrent families) the requests' rows are split over the batch's axes
instead, shape-guarded as `sharding.input_shardings` splits a batch: each
rank serves its rows through `serve` / `serve_batch`, samples their tokens
itself, and the tokens are gathered in rank order, while the host
decisions stay rank 0's.  An int8 / fp8 pool holds a rank's KV heads and
their per-page scales; a speculative round drafts on the same heads (a
foreign draft must be a server on the same mesh), verifies in one widened
step and takes rank 0's proposals, argmax chain and finiteness.  The QoS
governor plans on rank 0 alone, from rank 0's clock, and one broadcast a
re-selection hands its operating point to every rank (`_RankZeroGovernor`);
a graceful drain is rank 0's reading of its preemption handler (every rank
still polls its own); the tuner's runtime feedback refines from rank 0's
observations, rank 0 writes the cache and every rank returns its knobs.
Under `fsdp_sp` (the dense, MoE, encoder-decoder and VLM families, where
AutoShard picks it or it is forced) every rank serves the whole batch too
(replicated over `data`, as under Megatron's layout) with the whole
weights (FSDP blocks gathered at use), and holds its share of the
sequence of every KV cache and page pool (`sharding.seq_share`: a dense
cache's block of the slots, its slots of every page; an int8 / fp8 pool's
scales whole): a prompt the sequence axis divides prefills split over the
ranks, a decode step's tokens are whole on every rank, each rank attends
its slots and the ranks' partial softmax sums are merged
(`collectives.combine_attention`); every host decision stays rank 0's.

Both paths serve the dense family (yi-6b, gemma-2b); the recurrent families
(recurrentgemma-2b's RG-LRU state, rwkv6-3b's WKV state) serve through
`serve` / `serve_batch` only: their state is not paged, and `serve_stream` /
`serve_continuous` refuse them with the reference's `ValueError` before a
pool is allocated.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.strategies.resilience import (
    DEFAULT_POLICY,
    FaultError,
    NonFiniteLogits,
)
from repro_torch.core.weaver import WovenProgram
from repro_torch.distributed.collectives import broadcast, broadcast_object, on_rank_zero
from repro_torch.distributed.sharding import (gather_shards, input_shardings, local_shard,
                                             seq_share)
from repro_torch.distributed.fault import Watchdog
from repro_torch.kernels.flash_attention.ops import CACHE_QMAX, DEFAULT_PAGE_SIZE
from repro_torch.launch.mesh import is_live, require_mesh_on
from repro_torch.memo.table import MemoTable
from repro_torch.monitor.examon import ExamonBroker, get_default_broker
from repro_torch.nn.module import init_params, resolve_device
from repro_torch.runtime.pages import (
    PagedCacheManager,
    PoolAuditor,
    PoolExhausted,
    cdiv,
    paged_compatible,
)
from repro_torch.runtime.qos import QoSGovernor
from repro_torch.runtime.steps import (
    build_decode_step,
    build_paged_prefill_step,
    build_prefill_step,
    build_verify_step,
    stack_request_caches,
)
from repro_torch.versioning.libvc import LibVC


def _step_counts() -> dict[str, int]:
    """Model calls of a paged serve, by kind: the structure probe and the
    unshared prefills (dense prefill, one launch of the prefill kernel per
    layer), the prefills of a suffix or chunk over resident slots and the
    re-scores (one widened-q / single-q decode launch per layer), the plain
    decode steps, the speculative verify steps (one widened-q launch per
    layer) and the draft's single-token steps.  A server counts every call
    its own steps make: a self-draft's admissions and steps land in the
    target's counts, a foreign draft's in its own."""
    return {"probe": 0, "prefill": 0, "suffix_prefill": 0, "rescore": 0,
            "decode": 0, "verify": 0, "draft": 0}


# the extras TunedKernelAspect may set: rank 0's rule on a live mesh
TUNED_EXTRAS = ("flash_dkv_n_split", "flash_block_q", "flash_block_q_bwd",
                "flash_block_kv", "flash_block_kv_bwd", "flash_block_kv_dec",
                "flash_page_size", "flash_cache_dtype", "speculative_draft_len")


class _RankZeroGovernor:
    """A QoS governor on a live mesh: rank 0's governor plans and learns from
    rank 0's clock (its TTFTs and wave latencies, its modeled power report
    a wave), and one broadcast a re-selection hands the operating point it
    chose to every rank.  A follower rank's governor decides and observes
    nothing; `stats()` is rank 0's on every rank."""

    def __init__(self, gov: QoSGovernor, mesh):
        self.gov, self.mesh = gov, mesh
        self.lead = mesh.rank == 0
        self.reselect_every = gov.reselect_every

    def knob_values(self, name: str) -> tuple:
        return self.gov.knob_values(name)

    def decide(self, **load) -> dict:
        return on_rank_zero(lambda: self.gov.decide(**load), self.mesh)

    def observe(self, metric: str, value: float) -> None:
        if self.lead:
            self.gov.observe(metric, value)

    def observe_wave(self, dt_s: float, **kw) -> None:
        if self.lead:
            self.gov.observe_wave(dt_s, **kw)

    def stats(self) -> dict[str, Any]:
        return on_rank_zero(self.gov.stats, self.mesh)


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
    # around transient step faults, and PoolAuditor barriers; None falls
    # back to the woven "serve_resilience" policy (ResilienceAspect), then
    # to resilience.DEFAULT_POLICY
    deadline_s: float | None = None
    retries: int | None = None
    pool_audit: bool | None = None
    # streaming (serve_stream): tokens of a long admission prefilled per
    # decode wave (0/None: one-shot admission), and the QoS governor's
    # per-request latency SLOs (seconds), which override a governed
    # serve's policy
    prefill_chunk: int | None = None
    slo_ttft_s: float | None = None
    slo_tok_s: float | None = None


class Server:
    def __init__(self, woven: WovenProgram, cfg: ServerConfig, *, mesh=None,
                 margot=None, broker: ExamonBroker | None = None,
                 memo: MemoTable | None = None, draft: "Server | None" = None,
                 device: "str | torch.device | None" = None,
                 params: dict[str, Any] | None = None):
        """`device` defaults to the program's (the card unless the program
        was built for the CPU); a card that is absent raises.  `draft` is
        the server whose model drafts for speculative decoding (the
        registry's `draft_for` pairing, or any server on the same device);
        None self-drafts when a draft length is asked for.  `params` is the
        param tree of another server of the same woven program, on the same
        device, to share (a fleet's replicas hold one copy of the weights);
        None draws them from `cfg.seed`.  `mesh` is None, a mesh of one
        device (`launch/mesh.make_card_mesh`) on the server's device — the
        same steps, kernels and bits as None — or this rank's live mesh
        (`launch/mesh.make_mesh`), whose device is the server's: the
        parameters drawn are this rank's shards of the one-device ones."""
        self.woven = woven
        self.cfg = cfg
        self.draft = draft
        self.device = resolve_device(
            device if device is not None else woven.program.device)
        require_mesh_on(mesh, self.device)
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
                if kind == "probe":
                    # 1-token structure probe for the paged pool: a copied
                    # state pins cache_max_len=0 so the probe cache never
                    # materializes a dense max_len transient
                    return build_prefill_step(self.woven, mesh=self.mesh,
                                              variant=v, cache_max_len=0)
                if kind == "paged_prefill":
                    # writes the prompt suffix into the pool tensors in place
                    return build_paged_prefill_step(self.woven, mesh=self.mesh,
                                                    variant=v)
                # the decode step updates the cache tensors in place; every
                # caller rebinds the cache to the step's output.  The
                # re-score step passes the pool through untouched.
                return build_decode_step(self.woven, mesh=self.mesh, variant=v,
                                         rescore=kind == "rescore")

            # "fallback" falls back to the default *variant* when a variant's
            # step cannot be made.  Kernels are built at their first launch, not
            # here, so this cannot hide a failed kernel build.
            return LibVC(make_step, error_strategy="fallback")

        self.prefill_vc = build("prefill")
        self.decode_vc = build("decode")
        self.probe_vc = build("probe")
        self.paged_prefill_vc = build("paged_prefill")
        self.rescore_vc = build("rescore")
        shardings = None
        if self._live:
            from repro_torch.distributed.sharding import param_shardings
            from repro_torch.runtime.steps import check_on_mesh

            check_on_mesh(woven, mesh)
            shardings = param_shardings(woven.program.model, mesh, woven.state.rules)
            # the tuned kernel knobs are rank 0's (each rank read its tuner cache)
            for st in [woven.state, *woven.variants.values()]:
                st.extra.update(broadcast_object(
                    {k: v for k, v in st.extra.items() if k in TUNED_EXTRAS}, mesh))
        self.params = params if params is not None else init_params(
            woven.program.model, cfg.seed, woven.state.policies, self.device,
            shardings=shardings)
        self.served = 0
        # latency histories are sliding windows (deques), not unbounded lists
        self.history_window = 4096
        self.latencies: deque[float] = deque(maxlen=self.history_window)
        self.decode_step_latencies: deque[float] = \
            deque(maxlen=self.history_window)  # serve_stream steps
        # the kernel tuner's feedback (refine_kernel_tuner): decode-step
        # latencies by live batch, and the last paged signature served
        self._step_lat_by_batch: dict[int, deque[float]] = {}
        self._paged_sig = None
        self._paged_dtype = None
        self.last_pool_stats: dict[str, Any] | None = None  # serve_stream
        self.last_spec_stats: dict[str, Any] | None = None  # speculative serve
        self.last_fault_stats: dict[str, Any] | None = None  # resilience layer
        self.last_outcomes: list[dict[str, Any]] | None = None  # per request
        self.last_qos_stats: dict[str, Any] | None = None  # QoS governor
        # model calls of the last serve_stream, by kind: what its kernel
        # launches follow from
        self.last_step_counts: dict[str, int] | None = None
        self._steps = _step_counts()
        self._last_admit_rescored = False  # last admission was a re-score
        self._last_admit_fault = None  # fault spec its "paged_prefill" fired
        self._verify_steps: dict[tuple, Callable] = {}  # (variant, k) -> step

    @property
    def _live(self) -> bool:
        return is_live(self.mesh)

    @property
    def _split_rows(self) -> bool:
        """Whether each rank serves its own rows (`dp_fsdp`)."""
        return self._live and self.woven.state.extra.get("layout") == "dp_fsdp"

    def _rows(self, n: int):
        """The sharding of a batch of `n` rows over this rank's mesh, or None
        where every rank serves the whole batch."""
        if not self._split_rows:
            return None
        return input_shardings({"tokens": ((n, 1), torch.int32)}, self.mesh,
                               self.woven.state.rules)["tokens"]

    def _variant(self) -> str | None:
        if self.margot is None:
            return None
        knobs = on_rank_zero(lambda: dict(self.margot.update().knobs), self.mesh)
        self.info["knobs"].update(knobs)
        return knobs.get("variant") or knobs.get("precision_mix")

    def _begin(self) -> str | None:
        variant = self._variant()
        state = self.woven.variant_state(
            None if variant in (None, "__default__") else variant
        )
        state.extra["cache_max_len"] = self.cfg.max_cache_len
        return variant

    def _record(self, t0: float, n_requests: int) -> None:
        """Account one served call; its result is already on the host, so
        the device work is done."""
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        self.served += n_requests
        self.broker.publish("serve/latency/@host0", dt)
        if self.margot is not None:
            self.margot.observe("latency", dt)

    def _finish(self, key, result, t0: float, n_requests: int):
        self._record(t0, n_requests)
        if self.memo is not None:
            self.memo.update(key, result)
        return result

    def serve(self, tokens: np.ndarray, *, decode_tokens: int | None = None,
              inputs: dict[str, np.ndarray] | None = None) -> np.ndarray:
        """tokens: (B, S) prompt -> (B, N) generated ids (greedy).

        `inputs`: the prompt's other inputs, row for row with `tokens` — an
        encoder-decoder's `frames` (B, T, d_model), whose encoder states and
        cross caches the decode steps then carry, or a VLM's image prefix
        `embeds` (B, P, d_model), whose P tokens the decode positions
        count.  Without them an encoder-decoder's prefill fails, as the
        reference's does."""
        n = decode_tokens or self.cfg.decode_tokens
        extra = {k: np.asarray(v) for k, v in (inputs or {}).items()}
        key = ("serve", tokens.tobytes(), n,
               tuple((k, v.tobytes()) for k, v in sorted(extra.items())))
        if self.memo is not None and self.memo.running:
            hit, out = broadcast_object(self.memo.lookup(key), self.mesh)
            if hit:
                return out
        t0 = time.perf_counter()
        variant = self._begin()

        toks = torch.as_tensor(np.asarray(tokens), device=self.device).to(torch.int32)
        feed = {"tokens": toks}
        feed.update({k: torch.as_tensor(v, device=self.device) for k, v in extra.items()})
        rows = self._rows(toks.shape[0])
        if rows is not None:
            feed = {k: local_shard(v, rows) for k, v in feed.items()}
            toks = feed["tokens"]
        B, S = toks.shape
        logits, cache = self.prefill_vc(variant, self.params, feed)
        outs = []
        # a VLM's decode positions count its image prefix
        pos = S + (feed["embeds"].shape[1] if "embeds" in feed else 0)
        tok = self._sampled(torch.argmax(logits[:, -1], dim=-1)[:, None])
        for _ in range(n):
            outs.append(tok)
            logits, cache = self.decode_vc(
                variant, self.params,
                {"tokens": tok,
                 "positions": torch.full((B, 1), pos, dtype=torch.int32,
                                         device=self.device)},
                cache,
            )
            tok = self._sampled(torch.argmax(logits[:, -1], dim=-1)[:, None])
            pos += 1
        result = torch.cat(outs, dim=1)
        if rows is not None:
            result = gather_shards(result, rows)
        return self._finish(key, result.cpu().numpy(), t0, 1)

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
            hit, out = broadcast_object(self.memo.lookup(key), self.mesh)
            if hit:
                return out
        t0 = time.perf_counter()
        variant = self._begin()

        rows = self._rows(len(prompts))
        if rows is not None:  # this rank's requests
            mine = local_shard(torch.arange(len(prompts)), rows).tolist()
            prompts = [prompts[i] for i in mine]
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
        tok = self._sampled(torch.stack(first_toks).reshape(B, 1))
        outs = []
        for _ in range(n):
            outs.append(tok)
            logits, cache = self.decode_vc(
                variant, self.params,
                {"tokens": tok, "positions": pos[:, None]},
                cache,
            )
            tok = self._sampled(torch.argmax(logits[:, -1], dim=-1)[:, None])
            pos = pos + 1
        stacked = torch.cat(outs, dim=1)
        if rows is not None:
            stacked = gather_shards(stacked, rows)
        stacked = stacked.cpu().numpy()
        result = [stacked[b] for b in range(stacked.shape[0])]
        return self._finish(key, result, t0, len(result))

    def _sampled(self, tok: torch.Tensor) -> torch.Tensor:
        """Greedy tokens as int32, rank 0's on a live mesh (each rank's own
        where it serves its own rows)."""
        if self._split_rows:
            return tok.to(torch.int32)
        return broadcast(tok.to(torch.int32), self.mesh)

    # -- paged pool + continuous batching -----------------------------------------

    def _page_size(self, state) -> int:
        ps = self.cfg.page_size or state.extra.get("flash_page_size") \
            or DEFAULT_PAGE_SIZE
        return max(1, min(int(ps), self.cfg.max_cache_len))

    def _cache_dtype(self, state) -> str | None:
        """Resolved pool-quantization dtype name: explicit config wins, then
        the woven "flash_cache_dtype" knob.  Names outside CACHE_QMAX (fp
        names such as "float16") mean unquantized."""
        name = self.cfg.cache_dtype or state.extra.get("flash_cache_dtype")
        if name is None:
            return None
        name = str(name)
        return name if name in CACHE_QMAX else None

    def _tokens(self, prompt) -> tuple[torch.Tensor, np.ndarray]:
        """A prompt as a (1, S) int32 tensor on the device, and as int64 host
        ids (the prefix index's key material)."""
        toks_np = np.asarray(prompt, np.int64).reshape(-1)
        return torch.from_numpy(toks_np.astype(np.int32)).to(self.device)[None], toks_np

    def _first_token(self, manager: PagedCacheManager, rid, logits,
                     fault=None) -> int:
        """Greedy first token of an admission; NaN / Inf logits roll the
        request's pool state back and raise `NonFiniteLogits`.  A fired
        `nan_logits` fault spec poisons the logits first, driving the same
        detector a real NaN would hit."""
        if fault is not None and fault.kind == "nan_logits":
            logits = torch.full_like(logits, float("nan"))
        row = logits[0, -1]
        tok, top = broadcast_object(torch.stack([row.argmax().to(torch.float32),
                                                 row.to(torch.float32).amax()]).tolist(),
                                    self.mesh)
        if not np.isfinite(top):
            manager.abort(rid)
            raise NonFiniteLogits(f"non-finite prefill logits for request {rid!r}")
        return int(tok)

    def _ensure_structure(self, manager: PagedCacheManager, toks, variant) -> None:
        """Learn the pool's structure from a 1-token probe prefill (the
        first admission of a serve)."""
        if manager.has_structure:
            return
        _, probe = self.probe_vc(variant, self.params, {"tokens": toks[:, :1]})
        self._steps["probe"] += 1
        if not paged_compatible(probe):
            raise ValueError("model cache is not paged-compatible (SSM/recurrent "
                             "state) — use serve_batch")
        ring = manager.window is not None and manager.window < toks.shape[1]
        manager.init_structure(probe, ring=ring)

    def _blocked(self, variant, S: int) -> bool:
        """Whether a prompt of S tokens prefills on the plain path's blocked
        online softmax (a numeric family of its own)."""
        extra = self.woven.variant_state(
            None if variant in (None, "__default__") else variant).extra
        return S > 2 * int(extra.get("eager_attn_block", 1024))

    def _paged_admit(self, manager: PagedCacheManager, rid, prompt,
                     final_len: int, variant, inj=None) -> int:
        """Admit one request into the page pool, prefilling *directly into
        pool pages*, and return its first output token.

        The first admission runs a 1-token structure probe; every admission
        then matches the prompt against the prefix index — full-page hits
        map shared physical pages and only the non-shared suffix is
        prefilled, a full-prompt hit skips prefill entirely and re-scores
        the last prompt token for its logits.  Non-finite first logits roll
        the admission back and raise `NonFiniteLogits`.

        `inj` (a woven FaultInjector) is consulted at the "paged_prefill"
        join point before any pool allocation, so a raise-kind fault leaves
        nothing to roll back; the fired spec (or None) is left in
        `_last_admit_fault` for the caller (a `deadline` kind forces the
        request over its SLO)."""
        toks, toks_np = self._tokens(prompt)
        S = int(toks.shape[1])
        self._ensure_structure(manager, toks, variant)
        shared_pages, shared_len = manager.match_prefix(toks_np)
        if shared_len >= S and self._blocked(variant, S):
            # a long prompt's unshared first token comes from the plain
            # path's blocked softmax; the re-score step's one-shot softmax
            # is another numeric family, so keep >= 1 suffix token
            ps = manager.page_size
            if shared_len % ps:      # drop the shared tail page
                shared_pages = shared_pages[:-1]
                shared_len = (S // ps) * ps
            if shared_len >= S:      # page-aligned prompt: drop a page
                shared_pages = shared_pages[:-1]
                shared_len -= ps
        self._last_admit_rescored = shared_len >= S
        self._last_admit_fault = fault = \
            inj.fire("paged_prefill", rid=rid) if inj is not None else None
        if shared_len >= S:
            manager.admit_shared(rid, toks_np, final_len=final_len,
                                 pages=shared_pages)
            view = manager.rescore_view(rid)
            logits, _ = self.rescore_vc(
                variant, self.params,
                {"tokens": toks[:, -1:],
                 "positions": torch.full((1, 1), S - 1, dtype=torch.int32,
                                         device=self.device)},
                view)
            self._steps["rescore"] += 1
        else:
            view, start = manager.admit_begin(
                rid, toks_np, final_len=final_len,
                shared_pages=shared_pages, shared_len=shared_len)
            logits, new_cache = self._prefill_chunk(toks, start, S, view, variant)
            manager.admit_finish(rid, new_cache, toks_np)
        return self._first_token(manager, rid, logits, fault)

    def _prefill_chunk(self, toks, start: int, end: int, view, variant):
        """Prefill prompt tokens [start, end) over the `start` resident ones,
        into the pool (in place); returns the logits and the step's cache."""
        pos = torch.arange(start, end, dtype=torch.int32, device=self.device)[None]
        out = self.paged_prefill_vc(
            variant, self.params, {"tokens": toks[:, start:end], "positions": pos},
            view, prefix_len=start)
        self._steps["suffix_prefill" if start else "prefill"] += 1
        return out

    def _admit_grouped(self, manager: PagedCacheManager, rid, prompt,
                       final_len: int, first_tok: int) -> int | None:
        """Identical-prompt group admission: the member's full prompt is
        already pool-resident (its donor was just admitted through the
        re-score path), so it maps the donor's pages and reuses the donor's
        first token — one re-score step for the whole group.  Returns None
        (the caller falls back to a full `_paged_admit`) if the prompt is no
        longer a full-prefix hit."""
        toks_np = np.asarray(prompt, np.int64).reshape(-1)
        pages, shared_len = manager.match_prefix(toks_np)
        if shared_len < toks_np.shape[0]:
            return None
        manager.admit_shared(rid, toks_np, final_len=final_len, pages=pages)
        return int(first_tok)

    def _paged_admit_chunked(self, manager: PagedCacheManager, rid, prompt,
                             final_len: int, variant, inj=None, chunk: int = 0):
        """Chunked direct-to-pool admission: reserve the block table up
        front, then prefill page-aligned `chunk`-token slices of the
        non-shared suffix one call at a time, so a long admission spreads
        across decode waves instead of stalling the in-flight batch.

        Returns (tok, cont): tok set and cont None when the admission
        completed in one shot (full-prompt hit, ring pool, blocked-softmax
        prompt, or a suffix that fits one chunk); else tok None and cont a
        closure to call once per wave, returning {"tok": None, "resident":
        r, "chunk": c} after an interior chunk and {"tok": first_token, ...}
        after the final one.

        Parity: chunk boundaries are page multiples (every pool page is
        written by exactly one dispatch, so a quantized page's first-write
        scale matches a one-shot prefill), and each interior chunk runs the
        suffix-over-prefix shape a prefix-sharing admission uses.  The
        "paged_prefill" join point fires once, at reservation time, as the
        one-shot path fires it before pool allocation (`_last_admit_fault`).
        """
        toks, toks_np = self._tokens(prompt)
        S = int(toks.shape[1])
        self._ensure_structure(manager, toks, variant)
        shared_pages, shared_len = manager.match_prefix(toks_np)
        ps = manager.page_size
        step = max(ps, (int(chunk) // ps) * ps)  # page-aligned, >= 1 page
        if (shared_len >= S or manager._ring_pool() or self._blocked(variant, S)
                or S - shared_len <= step):
            return self._paged_admit(manager, rid, prompt, final_len, variant,
                                     inj=inj), None
        self._last_admit_rescored = False
        self._last_admit_fault = fault = \
            inj.fire("paged_prefill", rid=rid) if inj is not None else None
        _, start = manager.admit_begin(
            rid, toks_np, final_len=final_len,
            shared_pages=shared_pages, shared_len=shared_len)
        st = {"done": start}

        def cont() -> dict:
            done = st["done"]
            end = min(done + step, S)
            logits, new_cache = self._prefill_chunk(
                toks, done, end, manager.prefill_view(rid, done), variant)
            if end < S:
                manager.absorb_prefill(rid, new_cache)
                st["done"] = end
                return {"tok": None, "resident": end, "chunk": end - done}
            manager.admit_finish(rid, new_cache, toks_np)
            return {"tok": self._first_token(manager, rid, logits, fault),
                    "resident": S, "chunk": end - done}

        return None, cont

    def _resilience(self, state) -> dict[str, Any]:
        """Resolved recovery policy: resilience.DEFAULT_POLICY under the
        woven "serve_resilience" extra (ResilienceAspect), with explicit
        ServerConfig fields winning."""
        pol = dict(DEFAULT_POLICY)
        pol.update(state.extra.get("serve_resilience") or {})
        if self.cfg.deadline_s is not None:
            pol["deadline_s"] = float(self.cfg.deadline_s)
        if self.cfg.retries is not None:
            pol["retries"] = int(self.cfg.retries)
        if self.cfg.pool_audit is not None:
            pol["pool_audit"] = bool(self.cfg.pool_audit)
        return pol

    def _verify_step(self, variant, draft_len: int) -> Callable:
        """The widened-q verify step (S = draft_len + 1 q tokens per
        request), built once per (variant, draft_len); like the decode step
        it writes the pool in place (manager.absorb rebinds)."""
        key = (variant, draft_len)
        fn = self._verify_steps.get(key)
        if fn is None:
            v = None if variant in (None, "__default__") else variant
            fn = build_verify_step(self.woven, mesh=self.mesh, variant=v,
                                   draft_len=draft_len)
            self._verify_steps[key] = fn
        return fn

    @staticmethod
    def _draft_sync(draft_srv: "Server", dmanager: PagedCacheManager,
                    rids, active, outputs, lengths) -> None:
        """Restore the speculative lockstep invariant (draft resident
        length == target accepted length at round start) by replaying the
        target's emitted tokens through the draft cache.  Static-k serves
        never need this — rollback keeps both pools in sync — but a draft
        length lowered to 0 for some waves (the QoS governor's knob) leaves
        the draft behind by the tokens those plain waves emitted."""
        for r in rids:
            dlen = int(dmanager._meta[r]["length"])
            tgt = int(active[r]["pos"])
            while dlen < tgt:
                # slot p holds sequence token p; for p >= prompt length
                # that token is outputs[p - S]
                t = outputs[r][dlen - lengths[r]]
                tok_pos = torch.tensor([[t, dlen]], dtype=torch.int32).to(draft_srv.device)
                _, dnew = draft_srv.decode_vc(
                    None, draft_srv.params,
                    {"tokens": tok_pos[:, :1], "positions": tok_pos[:, 1:]},
                    dmanager.batch([r]))
                draft_srv._steps["draft"] += 1
                dmanager.absorb([r], dnew)
                dlen += 1

    def _qos_governor(self, state, qos, slo_ttft_s=None, slo_tok_s=None):
        """Resolve the serving QoS control plane: an explicit QoSGovernor
        (or policy dict) argument wins, then a woven `qos_governor`
        instance, then the woven `serve_qos` policy (QoSAspect); `False`
        forces it off.  ServerConfig / argument SLOs override the policy's
        before the governor is built."""
        if qos is False:
            return None
        if isinstance(qos, QoSGovernor):
            return qos
        if qos is None:
            gov = state.extra.get("qos_governor")
            if gov is not None:
                return gov
        pol = qos if isinstance(qos, dict) else state.extra.get("serve_qos")
        if pol is None:
            return None
        pol = dict(pol)
        for key, val in (("slo_ttft_s", self.cfg.slo_ttft_s),
                         ("slo_tok_s", self.cfg.slo_tok_s),
                         ("slo_ttft_s", slo_ttft_s), ("slo_tok_s", slo_tok_s)):
            if val is not None:
                pol[key] = float(val)
        if not pol.get("enabled", True):
            return None
        return QoSGovernor(pol, broker=self.broker)

    def _qos_enabled(self, qos) -> bool:
        """Cheap pre-check (no governor construction) used by the memo
        gate: would serve_stream run under a QoS control plane?"""
        if qos is False:
            return False
        if qos is not None:
            return True
        extra = self.woven.state.extra
        return extra.get("qos_governor") is not None \
            or extra.get("serve_qos") is not None

    def serve_continuous(self, prompts: list[np.ndarray], *,
                         decode_tokens: int | None = None,
                         page_size: int | None = None,
                         pool_pages: int | None = None,
                         max_batch: int | None = None,
                         prefix_sharing: bool | None = None,
                         draft_len: int | None = None,
                         draft: "Server | None" = None,
                         fault_injector=None,
                         deadline_s: float | None = None,
                         pool_audit: bool | None = None,
                         preemption=None,
                         prefill_chunk: int | None = None,
                         qos=None,
                         arrival_waves=None,
                         slo_ttft_s: float | None = None,
                         slo_tok_s: float | None = None,
                         on_event=None) -> list[np.ndarray]:
        """Continuous batching over a prefix-shared paged KV pool: the thin
        wrapper over the `serve_stream` event loop.  It handles the memo
        table (the stream engine never touches it), drains the event stream
        (`on_event` receives each event dict when given), and returns the
        collected outputs.

        Unlike `serve_batch`, the decode batch is re-formed every step:
        waiting requests are admitted as soon as the page pool covers their
        worst-case growth and a decode slot is free, each admission prefills
        its non-shared prompt suffix straight into pool pages (common
        prefixes map existing pages; the first write into a shared page
        splits it copy-on-write), and finished requests retire at once.
        Greedy decode, equal per request to `serve` / `serve_batch` wherever
        the matrix products do not depend on the batch (exactly so on the
        CPU).  Speculative decoding, the resilience layer, graceful drain
        and the QoS governor are `serve_stream`'s."""
        if not prompts:
            return []
        n = decode_tokens or self.cfg.decode_tokens
        k = draft_len if draft_len is not None else self.cfg.draft_len
        key = ("serve_continuous",
               tuple(np.asarray(p).tobytes() for p in prompts), n)
        if k:  # spec serves memoize separately (same tokens, different stats)
            key = key + (int(k),)
        cache_dtype = self._cache_dtype(self.woven.state)
        if cache_dtype:  # quantized pools emit different (clipped) logits
            key = key + (("cache_dtype", cache_dtype),)
        # armed fault injection, deadline policies and preemption make a
        # serve non-reproducible from its prompt key alone; chunked,
        # governed and arrival-clocked serves keep token parity but carry
        # per-wave stats and governor state a memo hit would skip: all of
        # them bypass the table
        pre_inj = fault_injector if fault_injector is not None \
            else self.woven.state.extra.get("fault_injector")
        pre_deadline = deadline_s if deadline_s is not None \
            else self._resilience(self.woven.state)["deadline_s"]
        chunk_pre = prefill_chunk if prefill_chunk is not None \
            else self.cfg.prefill_chunk
        memo_ok = (pre_inj is None or not pre_inj.armed) \
            and pre_deadline is None and preemption is None \
            and not chunk_pre and arrival_waves is None \
            and not self._qos_enabled(qos)
        if memo_ok and self.memo is not None and self.memo.running:
            hit, out = broadcast_object(self.memo.lookup(key), self.mesh)
            if hit:
                # a hit serves no step and builds no pool: clear what a
                # stats reader (or refine_kernel_tuner) would otherwise take
                # for this serve's
                self.decode_step_latencies = deque(maxlen=self.history_window)
                self._step_lat_by_batch = {}
                self._paged_sig = None
                self._paged_dtype = None
                self.last_pool_stats = None
                self.last_spec_stats = None
                self.last_fault_stats = None
                self.last_outcomes = None
                self.last_step_counts = None
                self.last_qos_stats = None
                return out
        gen = self.serve_stream(
            prompts, decode_tokens=n, page_size=page_size,
            pool_pages=pool_pages, max_batch=max_batch,
            prefix_sharing=prefix_sharing, draft_len=draft_len, draft=draft,
            fault_injector=fault_injector, deadline_s=deadline_s,
            pool_audit=pool_audit, preemption=preemption,
            prefill_chunk=prefill_chunk, qos=qos, arrival_waves=arrival_waves,
            slo_ttft_s=slo_ttft_s, slo_tok_s=slo_tok_s)
        while True:
            try:
                ev = next(gen)
            except StopIteration as stop:
                result = stop.value
                break
            if on_event is not None:
                on_event(ev)
        # fault-shaped results (rejections, quarantines, deadline cuts) are
        # never memoized: the key carries no pool geometry or fault
        # schedule, so a later right-sized serve would replay them
        fs = self.last_fault_stats
        clean = (memo_ok and fs["events"] == 0 and not fs["actions"]
                 and all(o["status"] == "ok" for o in self.last_outcomes))
        # on a live mesh the store is rank 0's decision: a watchdog overrun
        # is recorded (in `actions`) on the rank that saw it alone, and the
        # ranks' tables must not part
        if self.memo is not None and broadcast_object(clean, self.mesh):
            self.memo.update(key, result)
        return result

    def serve_stream(self, prompts: list[np.ndarray], *,
                     decode_tokens: int | None = None,
                     page_size: int | None = None,
                     pool_pages: int | None = None,
                     max_batch: int | None = None,
                     prefix_sharing: bool | None = None,
                     draft_len: int | None = None,
                     draft: "Server | None" = None,
                     fault_injector=None,
                     deadline_s: float | None = None,
                     pool_audit: bool | None = None,
                     preemption=None,
                     prefill_chunk: int | None = None,
                     qos=None,
                     arrival_waves=None,
                     slo_ttft_s: float | None = None,
                     slo_tok_s: float | None = None):
        """The streaming serving engine: a generator over per-token events.

        Admission, chunked prefill, decode / verify steps, retirement and
        fault isolation as an event loop that *yields* as tokens appear and
        *returns* the final per-request output list (read it from
        `StopIteration.value`, or use the `serve_continuous` wrapper).
        Event dicts (all carry "wave" — the logical wave index — and "t", a
        `perf_counter` stamp taken when the event was made):

          {"event": "admit",         "rid": r}
          {"event": "prefill_chunk", "rid": r, "resident": i, "total": S}
          {"event": "token",  "rid": r, "token": t, "index": i}
          {"event": "outcome","rid": r, "status": s, "reason": ..., "tokens": n}
          {"event": "wave",   "batch": B, "dt_s": dt, "emitted": e,
           "prefill_tokens": p, "k": k_eff, "op": o}

        (`o` is the operating point in force under the QoS governor —
        max_batch, chunk, k, freq — and None on an ungoverned serve.)

        Chunked prefill (`prefill_chunk` > 0, or ServerConfig's): a long
        admission reserves its block table up front, then prefills one
        page-aligned chunk per wave, so in-flight decodes keep emitting a
        token every wave while the newcomer streams in; outputs stay equal
        to one-shot admission (`_paged_admit_chunked`).  `arrival_waves`
        (one int per prompt) lands requests on a logical wave clock instead
        of all at wave 0.  Up to `max_batch` requests decode (or prefill)
        at once; a queued request whose prompt prefix is resident jumps a
        head of the queue that cannot fit, and identical queued prompts
        admit as a group off one re-score.

        Speculative decoding (`draft_len` = k > 0, explicit, from
        ServerConfig, or from the woven "speculative_draft_len" knob): a
        draft model (`draft`, the constructor's pairing, or this server
        itself) proposes k greedy tokens per round from its own unshared
        page pool, and the target scores all k+1 positions in ONE
        widened-q verify step; the longest draft prefix matching the
        target's own argmax chain is accepted with the target's correction,
        and the rejected tail of both pools rolls back by refcount alone (no
        page copies).  Every emitted token is a target argmax, so the output
        equals plain greedy wherever a widened row equals a single-token
        row (exactly so on the CPU); the draft only changes how many target
        steps it takes.  Ring pools fall back to plain decode; acceptance
        stats land in `last_spec_stats`.

        Resilience (a woven ResilienceAspect, or the `fault_injector` /
        `deadline_s` / `pool_audit` arguments): faults are isolated per
        request.  The injector is consulted at the join points of
        `core/strategies/resilience.JOIN_POINTS`; failed or oversized
        admissions get structured `last_outcomes` entries; NaN / Inf logits
        quarantine only the victim; draft faults degrade speculation to
        plain decode; overdue requests retire with partial output and a
        `deadline_exceeded` marker; transient step faults retry with
        bounded backoff; `pool_audit` runs PoolAuditor barriers after every
        rollback, retirement and recovery.  No fault escapes as an
        exception.  `last_fault_stats` and the ExaMon topics
        `serve/fault/{point}/{kind}@host0` record every injected event
        (zero when nothing is woven).

        Graceful drain (`preemption`, a PreemptionHandler or anything with a
        `.pending` bool): once preemption is requested no new request is
        admitted; in-flight requests finish their decode, and the waiting
        queue returns structured `drained` outcomes.  On a live mesh rank
        0's reading drains every rank at the same wave.

        QoS (`qos`, a QoSGovernor or a policy dict; else a woven QoSAspect;
        `qos=False` forces it off; `slo_ttft_s` / `slo_tok_s`, or
        ServerConfig's, override the policy's SLOs): every
        `reselect_every` waves the governor re-plans the operating point
        for the current load — `max_batch` (clamped to the serve's own),
        `prefill_chunk` (unless the caller fixed one), `draft_len` (the
        verify slack and the draft pool are sized for the grid's largest,
        and a draft left behind by plain waves is replayed before the next
        verify round) and the modeled `freq`.  Knob moves change only
        scheduling: every emitted token is still a target argmax.  Each
        wave's latency is observed (`observe_wave`), each first token's
        TTFT too; `last_qos_stats` holds the governor's `stats()` and every
        `wave` event carries the operating point in force as `op`.  On a
        live mesh these are rank 0's: its governor plans from its own clock
        and every rank takes the operating point it chose.

        `last_pool_stats`, `last_spec_stats`, `last_fault_stats`,
        `last_qos_stats`, `last_step_counts` and `decode_step_latencies`
        describe the serve.
        """
        if not prompts:
            return []
        n = decode_tokens or self.cfg.decode_tokens
        k = draft_len if draft_len is not None else self.cfg.draft_len
        t0 = time.perf_counter()
        variant = self._begin()
        state = self.woven.variant_state(
            None if variant in (None, "__default__") else variant)
        ps = page_size or self._page_size(state)
        cache_dtype = self._cache_dtype(state)
        res = self._resilience(state)
        if deadline_s is not None:
            res["deadline_s"] = float(deadline_s)
        if pool_audit is not None:
            res["pool_audit"] = bool(pool_audit)
        inj = fault_injector if fault_injector is not None \
            else state.extra.get("fault_injector")
        gov = self._qos_governor(state, qos, slo_ttft_s, slo_tok_s)
        if gov is not None and self._live:
            gov = _RankZeroGovernor(gov, self.mesh)
        # chunked prefill: explicit argument, then ServerConfig, then the
        # governor's prefill_chunk knob (0/None: one-shot admission).
        # Capacity-routed MoE couples a prefill's tokens within their group
        # (capacity and drops see the whole dispatch), so a chunked prefill
        # would not give the one-shot bits: the gate stays off there.
        moe = self.woven.program.cfg.family == "moe"
        chunk_ok = not moe
        chunk_cfg = prefill_chunk if prefill_chunk is not None \
            else self.cfg.prefill_chunk

        if k is None:
            k = int(state.extra.get("speculative_draft_len", 0) or 0)
        k = max(0, int(k))
        # the governor may raise draft_len at runtime: reserve verify slack
        # (and size the draft pool) for the largest knob value
        k_max = k
        if gov is not None:
            k_max = max([k] + [int(v) for v in gov.knob_values("draft_len")])

        lengths = [int(np.asarray(p).reshape(-1).shape[0]) for p in prompts]
        # speculative verify steps write up to k slots past the accepted
        # length before rolling back — reserve that slack at admission so
        # draft-block writes can never outrun the block table
        finals = [min(S + n - 1 + k_max, self.cfg.max_cache_len) for S in lengths]
        max_batch = max_batch or self.cfg.max_batch or len(prompts)
        pool_pages = pool_pages or self.cfg.pool_pages \
            or max(sum(cdiv(f, ps) for f in finals), 1)
        share = self.cfg.prefix_sharing if prefix_sharing is None \
            else prefix_sharing
        if moe:
            # the group coupling again: a prefix's K/V depend on the tokens
            # routed beside it, so a sharer's recompute could write other
            # bytes into pages its donor still maps.  Sharing stays off; the
            # direct-to-pool paged prefill still applies.
            share = False
        manager = PagedCacheManager(
            pool_pages, ps, max_len=self.cfg.max_cache_len,
            window=getattr(self.woven.program.cfg, "attn_window", None),
            prefix_sharing=share, cache_dtype=cache_dtype,
            share=seq_share(self.mesh, state.rules, ps))
        # feedback observations are per knob setting: a fresh window,
        # bucketed by live batch (a step's cost scales with it, and the
        # tuner's signature is keyed to one batch)
        self.decode_step_latencies = deque(maxlen=self.history_window)
        self._step_lat_by_batch = {}
        seen_batches: set[int] = set()
        self._steps = _step_counts()

        if k_max and moe:
            # an S-token verify step routes its tokens as one group, with
            # other capacity and drop decisions than S one-token steps: its
            # logits would not be plain decode's.  Speculation stays off.
            k = k_max = 0
        draft_srv = draft or self.draft or self  # self-speculation default
        dmanager: PagedCacheManager | None = None
        if k_max and (self._live or is_live(draft_srv.mesh)) \
                and draft_srv.mesh != self.mesh:
            # every rank drafts on its own heads in lockstep with its target
            raise ValueError("a draft server must be on its target's mesh: the "
                             f"target's is {self.mesh}, the draft's {draft_srv.mesh}")
        if k_max:
            # the draft keeps its own (unshared) page pool with the same
            # continuous-batching dynamics; sized for full concurrency so a
            # draft admission can never fail behind a target admission
            dstate = draft_srv.woven.variant_state(None)
            dstate.extra["cache_max_len"] = self.cfg.max_cache_len
            dmanager = PagedCacheManager(
                max(sum(cdiv(f, ps) for f in finals), 1), ps,
                max_len=self.cfg.max_cache_len,
                window=getattr(draft_srv.woven.program.cfg, "attn_window", None),
                prefix_sharing=False, cache_dtype=cache_dtype,
                share=seq_share(draft_srv.mesh, dstate.rules, ps))
            if draft_srv is not self:
                draft_srv._steps = _step_counts()

        arrive_at = None
        if arrival_waves is not None:
            if len(arrival_waves) != len(prompts):
                raise ValueError("arrival_waves must have one wave index "
                                 "per prompt")
            arrive_at = [max(0, int(w)) for w in arrival_waves]
        waiting: deque = deque()              # arrived, not yet admitted
        pending: deque = deque()              # not yet arrived (wave clock)
        if arrive_at is None:
            waiting.extend(range(len(prompts)))
        else:
            pending.extend(sorted(range(len(prompts)),
                                  key=lambda r: (arrive_at[r], r)))
        active: dict[int, dict] = {}          # rid -> {"tok", "pos"}
        prefilling: dict[int, Any] = {}       # rid -> chunked-admit cont
        outputs: dict[int, list[int]] = {}
        spec = {"on": False, "checked": False}
        verify_lats: list[float] = []
        stats = {"draft_len": k, "rounds": 0, "request_rounds": 0,
                 "proposed": 0, "accepted": 0, "emitted_spec": 0,
                 "draft_steps": 0, "verify_steps": 0, "decode_steps": 0}
        grouped = {"admissions": 0}  # identical-prompt shared re-scores
        # the live operating point: base values from the arguments / config,
        # re-selected by the governor as load shifts (closures read this)
        knobs = {"max_batch": max_batch,
                 "chunk": int(chunk_cfg or 0) if chunk_ok else 0,
                 "k": k, "freq": 1.0}

        evq: list[dict] = []
        wave = 0
        wavestat = {"emitted": 0, "prefill_tokens": 0}
        now0 = time.perf_counter()
        rq: dict[int, dict] = {
            r: {"arrive_t": now0, "arrive_wave": 0, "first_t": None,
                "first_wave": None, "tok_t": []}
            for r in range(len(prompts))}

        def _emit(kind: str, **kw) -> None:
            evq.append({"event": kind, "wave": wave,
                        "t": time.perf_counter(), **kw})

        def _first_token(rid, tok) -> None:
            outputs[rid] = [tok]
            active[rid] = {"tok": tok, "pos": lengths[rid]}
            m = rq[rid]
            m["first_t"] = time.perf_counter()
            m["first_wave"] = wave
            m["tok_t"].append(m["first_t"])
            wavestat["emitted"] += 1
            _emit("token", rid=rid, token=tok, index=0)
            if gov is not None:
                gov.observe("ttft_s", m["first_t"] - m["arrive_t"])

        # -- resilience machinery ---------------------------------------------
        # every fault the policy can absorb lands in `outcome` / `actions`
        # instead of escaping; with no injector woven and no deadline policy
        # this layer is pass-through
        outcome = {r: {"status": "ok", "reason": None}
                   for r in range(len(prompts))}
        actions: list[dict] = []  # recovery actions taken (host side)
        inj_seen = len(inj.events) if inj is not None else 0
        fstats = {"retries": 0, "quarantined": 0, "rejected": 0,
                  "oversized": 0, "deadline_exceeded": 0, "failed": 0,
                  "drained": 0, "degraded": None, "audits": 0,
                  "watchdog_timeouts": 0}
        start_t: dict[int, float] = {}     # admission wall clock per request
        forced_deadline: set[int] = set()  # injected SLO overruns
        deadline_s_eff = res["deadline_s"]
        retries_max = int(res["retries"])
        backoff_s = float(res["backoff_s"])
        watchdog: Watchdog | None = None
        if res["step_deadline_s"]:
            watchdog = Watchdog(
                float(res["step_deadline_s"]),
                lambda: actions.append({"point": "decode_step",
                                        "kind": "watchdog_overrun"}))

        class _StepAbort(Exception):
            """A step failed past the retry budget (or non-transiently):
            the serve drains with structured `failed` outcomes instead of
            letting the exception escape."""

            def __init__(self, point, cause):
                super().__init__(f"{point}: {cause}")
                self.point, self.cause = point, cause

        def _fire(point, *, rid=None, rids=None):
            if inj is None:
                return None
            fired = inj.fire(point, rid=rid, rids=rids)
            if fired is not None and fired.kind == "deadline" \
                    and fired.rid is not None:
                # SLO overrun: the sweep at the next round start retires the
                # victim with partial output
                forced_deadline.add(fired.rid)
            return fired

        def _retry(point, fn):
            """Bounded retry-with-backoff around one step's transient faults
            (injected raises and pool exhaustion fire *before* the step
            writes the pool, so re-running is safe; manager.batch is
            idempotent).  Anything else aborts the serve's stepping via
            _StepAbort — never by letting the exception escape."""
            attempt = 0
            while True:
                try:
                    return fn()
                except (FaultError, PoolExhausted) as e:
                    attempt += 1
                    fstats["retries"] += 1
                    actions.append({"point": point, "kind": "retry",
                                    "attempt": attempt, "error": str(e)})
                    if attempt > retries_max:
                        raise _StepAbort(point, e) from e
                    if backoff_s:
                        time.sleep(backoff_s * (2 ** (attempt - 1)))
                except Exception as e:  # non-transient: no retry
                    raise _StepAbort(point, e) from e

        def _audit():
            # PoolAuditor barriers under the debug knob: corruption is
            # caught at the fault, not three steps later
            if not res["pool_audit"]:
                return
            fstats["audits"] += 1
            PoolAuditor(manager, check_device=True).audit()
            if dmanager is not None:
                PoolAuditor(dmanager).audit()

        def _reject(rid, reason, status="rejected"):
            outcome[rid] = {"status": status, "reason": reason}
            fstats[status] += 1
            actions.append({"point": "admit", "kind": status, "rid": rid,
                            "reason": reason})
            _emit("outcome", rid=rid, status=status, reason=reason,
                  tokens=len(outputs.get(rid, [])))

        def _drop(rid):
            """Release every trace of `rid` from both pools + the batch."""
            manager.abort(rid)
            if dmanager is not None:
                dmanager.abort(rid)
            active.pop(rid, None)
            prefilling.pop(rid, None)
            start_t.pop(rid, None)
            forced_deadline.discard(rid)

        def _quarantine(rid, reason):
            # NaN/Inf logits quarantine exactly the victim: its pages
            # retire, its partial output survives, the batch re-forms
            outcome[rid] = {"status": "quarantined", "reason": reason}
            fstats["quarantined"] += 1
            actions.append({"point": "decode_step", "kind": "quarantined",
                            "rid": rid, "reason": reason})
            _emit("outcome", rid=rid, status="quarantined", reason=reason,
                  tokens=len(outputs.get(rid, [])))
            _drop(rid)

        def _degrade(reason):
            """Speculation is an optimization: any draft-side fault (or
            repeated all-reject verify rounds under the patience policy)
            turns it off for the rest of the serve — a draft failure never
            touches target state, so the output is unchanged."""
            if not spec["on"]:
                return
            spec["on"] = False
            fstats["degraded"] = reason
            actions.append({"point": "draft_step", "kind": "degraded",
                            "reason": reason})
            if dmanager is not None:
                for r in list(dmanager.pool.tables):
                    dmanager.abort(r)

        def _retire(rid):
            try:
                _retry("retire", lambda: (_fire("retire", rid=rid),
                                          manager.retire(rid)))
            except _StepAbort as e:
                # a retire that keeps failing force-drops the references —
                # leaking pages on a fault path would starve later admissions
                manager.abort(rid)
                actions.append({"point": "retire", "kind": "forced_abort",
                                "rid": rid, "error": str(e.cause)})
            if dmanager is not None:
                dmanager.abort(rid)

        def admit_one(rid, reuse_from=None) -> None:
            aspec = _fire("admit", rid=rid)
            if aspec is not None and aspec.kind == "nan_logits":
                # an admission with poisoned logits has no usable first
                # token: reject it through the non-finite path
                raise NonFiniteLogits(
                    f"injected non-finite admission logits for {rid!r}")
            _emit("admit", rid=rid)
            tok = None
            if reuse_from is not None:
                tok = self._admit_grouped(manager, rid, prompts[rid],
                                          finals[rid], outputs[reuse_from][0])
                if tok is not None:
                    grouped["admissions"] += 1
            cont = None
            if tok is None:
                chunk = int(knobs["chunk"] or 0)
                if chunk > 0:
                    tok, cont = self._paged_admit_chunked(
                        manager, rid, prompts[rid], finals[rid], variant,
                        inj=inj, chunk=chunk)
                else:
                    tok = self._paged_admit(manager, rid, prompts[rid],
                                            finals[rid], variant, inj=inj)
                pspec = self._last_admit_fault
                if pspec is not None and pspec.kind == "deadline":
                    forced_deadline.add(rid)
                if cont is None:
                    # a one-shot admission processed the whole prompt this
                    # wave: billed into the wave event like a chunk is
                    wavestat["prefill_tokens"] += lengths[rid]
            start_t[rid] = time.monotonic()
            if cont is not None:
                prefilling[rid] = cont  # the prompt streams in, chunk by chunk
            else:
                _first_token(rid, tok)
            if not spec["checked"]:
                # the pool family is known after the first admission: ring
                # pools evict on write, which breaks the widened-q verify
                # mask — speculation runs on linear pools only
                spec["checked"] = True
                spec["on"] = bool(k_max) and not manager._ring_pool()
            if spec["on"]:
                # the draft admits in lockstep (its length must equal the
                # target's accepted length at every round start); a draft
                # admission fault degrades speculation but keeps the target
                # admission — the request decodes plain
                try:
                    draft_srv._paged_admit(dmanager, rid, prompts[rid],
                                           finals[rid], None, inj=inj)
                except Exception as e:
                    _degrade(f"draft admission failed: {e}")

        def try_admit(rid, reuse_from=None) -> bool:
            try:
                admit_one(rid, reuse_from)
                return True
            except (FaultError, PoolExhausted) as e:
                # isolated to the one request: its partial pool state rolls
                # back and it gets a structured rejection
                outputs.pop(rid, None)
                _drop(rid)
                _reject(rid, str(e))
                _audit()
                return False

        def admit_ready() -> None:
            # chunked prefills in flight hold reserved pages and will join
            # the decode batch: the max_batch knob bounds active + prefilling
            while waiting and len(active) + len(prefilling) < int(knobs["max_batch"]):
                rid = None
                if manager.prefix_sharing and len(waiting) > 1:
                    # prefix-aware admission: a sharer queued behind a
                    # non-sharer jumps the line while its donor's pages are
                    # live — the shared prefix costs it no fresh pages
                    for cand in waiting:
                        toks_np = np.asarray(prompts[cand], np.int64).reshape(-1)
                        _, sl = manager.match_prefix(toks_np)
                        if sl > 0 and manager.can_admit(finals[cand],
                                                        tokens=prompts[cand]):
                            rid = cand
                            break
                if rid is None:
                    rid = waiting[0]
                    # capacity-checked for the very first admission too: an
                    # oversized request is rejected before its prefill runs
                    if not manager.can_admit(finals[rid], tokens=prompts[rid]):
                        return
                ok = try_admit(rid)
                waiting.remove(rid)
                if not (ok and manager.prefix_sharing and waiting
                        and self._last_admit_rescored):
                    continue
                # identical queued prompts admit as a group sharing the
                # re-score that just ran
                base = np.asarray(prompts[rid], np.int64).reshape(-1)
                for cand in [c for c in waiting if np.array_equal(
                        np.asarray(prompts[c], np.int64).reshape(-1), base)]:
                    if len(active) + len(prefilling) >= int(knobs["max_batch"]) \
                            or not manager.can_admit(finals[cand],
                                                     tokens=prompts[cand]):
                        break
                    try_admit(cand, reuse_from=rid)
                    waiting.remove(cand)

        def _drain_waiting() -> None:
            """Preemption: hand the not-yet-admitted queue back with
            structured `drained` outcomes — in-flight work is untouched.
            Future arrivals drain too: a preempted server never reaches
            their wave."""
            while pending:
                waiting.append(pending.popleft())
            while waiting:
                rid = waiting.popleft()
                outcome[rid] = {"status": "drained",
                                "reason": "preemption requested: "
                                          "admissions stopped"}
                fstats["drained"] += 1
                actions.append({"point": "drain", "kind": "drained",
                                "rid": rid})
                _emit("outcome", rid=rid, status="drained",
                      reason=outcome[rid]["reason"], tokens=0)

        def _preempted() -> bool:
            # every rank polls its own handler (a counting poller keeps one
            # count on every rank); rank 0's reading drains every rank
            return broadcast_object(bool(preemption.pending), self.mesh)

        def _admit_or_drain() -> None:
            if preemption is not None and _preempted():
                _drain_waiting()
                return
            admit_ready()

        # prompts the cache could never host are rejected up front
        for r in [r for r in list(waiting) + list(pending)
                  if lengths[r] > self.cfg.max_cache_len]:
            (waiting if r in waiting else pending).remove(r)
            _reject(r, f"prompt ({lengths[r]} tokens) exceeds "
                       f"max_cache_len ({self.cfg.max_cache_len})",
                    status="oversized")

        mismatch_rounds = 0
        aborted: _StepAbort | None = None
        while active or waiting or prefilling or pending:
            while evq:
                yield evq.pop(0)
            t_wave = time.perf_counter()
            wavestat["emitted"] = 0
            wavestat["prefill_tokens"] = 0
            # logical-clock arrivals land before anything else this wave
            if pending:
                arrived = False
                while pending and arrive_at[pending[0]] <= wave:
                    r = pending.popleft()
                    waiting.append(r)
                    rq[r]["arrive_t"] = time.perf_counter()
                    rq[r]["arrive_wave"] = wave
                    arrived = True
                if arrived:
                    _admit_or_drain()
            # the governor re-selects the serving operating point as load
            # shifts (every reselect_every waves); knob moves only change
            # scheduling — every emitted token stays a target argmax
            if gov is not None and wave % gov.reselect_every == 0:
                op = gov.decide(wave=wave, waiting=len(waiting) + len(pending),
                                active=len(active) + len(prefilling))
                v = op.get("max_batch")
                knobs["max_batch"] = min(max_batch, int(v)) if v else max_batch
                if chunk_ok and chunk_cfg is None \
                        and op.get("prefill_chunk") is not None:
                    knobs["chunk"] = int(op["prefill_chunk"])
                if op.get("draft_len") is not None:
                    knobs["k"] = min(k_max, int(op["draft_len"]))
                if op.get("freq") is not None:
                    knobs["freq"] = float(op["freq"])
            if wave == 0:
                _admit_or_drain()
            # preemption arriving mid-serve drains the queue at the next
            # round boundary; the admitted batch keeps decoding to the end
            if preemption is not None and _preempted() and (waiting or pending):
                _drain_waiting()
                if not active and not prefilling:
                    break
            # retire before stepping: requests at their budget free pages
            done = [r for r in active if len(outputs[r]) >= n]
            for rid in done:
                _retire(rid)
                del active[rid]
                _emit("outcome", rid=rid, status=outcome[rid]["status"],
                      reason=outcome[rid]["reason"],
                      tokens=len(outputs[rid][:n]))
            # per-request SLO sweep: overdue requests (wall clock past
            # deadline_s, or forced over by an injected `deadline` fault)
            # retire with partial output and a deadline_exceeded marker —
            # chunked admissions still prefilling are swept too
            overdue = []
            if deadline_s_eff is not None or forced_deadline:
                now = time.monotonic()
                overdue = [r for r in list(active) + list(prefilling)
                           if r in forced_deadline
                           or (deadline_s_eff is not None
                               and now - start_t[r] > deadline_s_eff)]
            overdue = broadcast_object(overdue, self.mesh)
            for rid in overdue:
                outcome[rid] = {"status": "deadline_exceeded",
                                "reason": "request exceeded its deadline"}
                fstats["deadline_exceeded"] += 1
                actions.append({"point": "decode_step", "kind": "deadline",
                                "rid": rid,
                                "emitted": len(outputs.get(rid, []))})
                _emit("outcome", rid=rid, status="deadline_exceeded",
                      reason=outcome[rid]["reason"],
                      tokens=len(outputs.get(rid, [])))
                if rid in prefilling:
                    # mid-prefill: nothing registered yet — abort the
                    # reserved pages instead of retiring
                    del prefilling[rid]
                    _drop(rid)
                else:
                    _retire(rid)
                    active.pop(rid, None)
                forced_deadline.discard(rid)
            if done or overdue:
                _audit()
                _admit_or_drain()
            # advance chunked prefills: one page-aligned chunk per request
            # per wave, beside the in-flight decodes
            for rid in list(prefilling):
                try:
                    step_r = prefilling[rid]()
                except (FaultError, PoolExhausted) as e:
                    outputs.pop(rid, None)
                    _drop(rid)
                    _reject(rid, str(e))
                    _audit()
                    continue
                wavestat["prefill_tokens"] += step_r["chunk"]
                if step_r["tok"] is None:
                    _emit("prefill_chunk", rid=rid,
                          resident=step_r["resident"], total=lengths[rid])
                else:
                    del prefilling[rid]
                    _first_token(rid, step_r["tok"])
            if not active:
                if waiting and not prefilling:
                    # the pool at its emptiest cannot fit the head request:
                    # reject it and keep serving the rest
                    rid = waiting.popleft()
                    _reject(rid, f"page pool too small: request {rid} "
                                 f"needs more pages than the pool holds")
                    _admit_or_drain()
                    wave += 1
                    continue
                if prefilling or pending:
                    # nothing to decode this wave: prefill chunks advanced
                    # above / the clock ticks toward the next arrival
                    wave += 1
                    continue
                break

            rids = list(active)
            # a verify round writes k+1 slots per request; past the final_len
            # clamp (cache capacity) the round falls back to plain decode
            k_eff = int(knobs["k"]) if spec["on"] else 0
            S = k_eff + 1 if (k_eff and all(
                active[r]["pos"] + k_eff + 1 <= finals[r] for r in rids)) else 1

            if S > 1:
                # a draft left behind the target's accepted length (plain
                # waves of a governed draft length) catches up first;
                # static-k serves never enter the replay loop
                try:
                    self._draft_sync(draft_srv, dmanager, rids, active,
                                     outputs, lengths)
                except Exception as e:
                    _degrade(f"draft catch-up fault: {e}")
                    S = 1

            if S > 1:
                pos0 = {r: active[r]["pos"] for r in rids}
                # each request's last token and first draft position: one
                # host-to-device copy; the draft's proposals stay on the device
                tok_pos = torch.tensor([[active[r]["tok"], pos0[r]] for r in rids],
                                       dtype=torch.int32).to(draft_srv.device)
                fed = torch.empty((len(rids), S), dtype=torch.int32,
                                  device=draft_srv.device)
                fed[:, 0] = tok_pos[:, 0]
                # the draft proposes k greedy tokens; the last iteration is a
                # write-only catch-up (its K/V at slot pos+k is needed when
                # every proposal is accepted), its proposal unused
                try:
                    for s in range(S):
                        dspec = _fire("draft_step", rids=rids)
                        dlogits, dnew = draft_srv.decode_vc(
                            None, draft_srv.params,
                            {"tokens": fed[:, s:s + 1],
                             "positions": tok_pos[:, 1:] + s},
                            dmanager.batch(rids))
                        draft_srv._steps["draft"] += 1
                        if dspec is not None and dspec.kind == "nan_logits":
                            # a poisoned proposal is still a legal token after
                            # argmax (a NaN row argmaxes to 0): the verify step
                            # rejects garbage, so a bad draft costs steps only
                            dlogits[rids.index(dspec.rid)
                                    if dspec.rid in rids else 0] = float("nan")
                        dmanager.absorb(rids, dnew)
                        stats["draft_steps"] += 1
                        if s < S - 1:
                            fed[:, s + 1] = dlogits[:, -1].argmax(dim=-1)
                except Exception as e:
                    # draft-side fault: no target state was touched this
                    # round — degrade to plain decode and re-run the round
                    _degrade(f"draft fault: {e}")
                    wave += 1
                    continue
                fed = fed.to(self.device)
                vpos = tok_pos[:, 1:].to(self.device) \
                    + torch.arange(S, dtype=torch.int32, device=self.device)

                # ONE widened-q target step scores all S draft positions
                def _verify_round():
                    _fire("cow", rids=rids)
                    cache = manager.batch(rids, tokens=S)
                    vspec = _fire("verify_step", rids=rids)
                    ts = time.perf_counter()
                    if watchdog is not None:
                        watchdog.beat()
                    logits, new_cache = self._verify_step(variant, k_eff)(
                        self.params, {"tokens": fed, "positions": vpos}, cache)
                    self._steps["verify"] += 1
                    if watchdog is not None:
                        watchdog.cancel()
                    return vspec, ts, logits, new_cache

                try:
                    vspec, ts, logits, new_cache = _retry("verify_step",
                                                          _verify_round)
                except _StepAbort as err:
                    aborted = err
                    break
                if vspec is not None and vspec.kind == "nan_logits":
                    logits[rids.index(vspec.rid) if vspec.rid in rids else 0] = \
                        float("nan")
                # one transfer: the proposals, the target's argmax chain and
                # whether each request's rows are finite — rank 0's on a
                # live mesh, as a decode step's argmax is
                finite = torch.isfinite(logits.to(torch.float32).amax(dim=(-2, -1)))
                host = broadcast_object(torch.cat([
                    fed.to(torch.long), logits.argmax(dim=-1),
                    finite[:, None].to(torch.long)], dim=1).tolist(), self.mesh)
                verify_lats.append(time.perf_counter() - ts)
                manager.absorb(rids, new_cache, advance=S)
                stats["verify_steps"] += 1
                stats["rounds"] += 1
                stats["request_rounds"] += len(rids)
                accepted_round = 0
                rolled = False
                t_tok = time.perf_counter()
                for i, rid in enumerate(rids):
                    prop, targ, ok = host[i][:S], host[i][S:2 * S], host[i][2 * S]
                    if not ok:
                        _quarantine(rid, "non-finite verify logits")
                        rolled = True
                        continue
                    # accept the longest draft prefix matching the target's
                    # own argmax chain, plus the correction token — every
                    # emitted token is a target argmax
                    a = 0
                    while a < k_eff and prop[a + 1] == targ[a]:
                        a += 1
                    e = min(a + 1, n - len(outputs[rid]))
                    idx0 = len(outputs[rid])
                    outputs[rid].extend(targ[:e])
                    new_len = pos0[rid] + e
                    # the rejected tail: O(1) refcount rollback, no page copy
                    try:
                        _retry("rollback", lambda rid=rid, nl=new_len: (
                            _fire("rollback", rid=rid),
                            manager.rollback(rid, nl),
                            dmanager.rollback(rid, nl)))
                    except _StepAbort as err:
                        # a rollback that keeps failing leaves the request's
                        # length unknown: quarantine it
                        _quarantine(rid, f"rollback failed: {err.cause}")
                        rolled = True
                        continue
                    active[rid]["tok"] = targ[e - 1]
                    active[rid]["pos"] = new_len
                    for j in range(e):
                        rq[rid]["tok_t"].append(t_tok)
                        _emit("token", rid=rid, token=targ[j], index=idx0 + j)
                    wavestat["emitted"] += e
                    stats["proposed"] += k_eff
                    stats["accepted"] += a
                    stats["emitted_spec"] += e
                    accepted_round += a
                    rolled = True
                if rolled:
                    _audit()
                if accepted_round == 0:
                    mismatch_rounds += 1
                    patience = res["spec_patience"]
                    if patience is not None and mismatch_rounds >= int(patience):
                        _degrade(f"{mismatch_rounds} consecutive all-reject "
                                 f"verify rounds")
                else:
                    mismatch_rounds = 0
            else:
                def _decode_round():
                    _fire("cow", rids=rids)
                    cache = manager.batch(rids)
                    pspec = _fire("decode_step", rids=rids)
                    # this step's tokens and positions: one host-to-device copy
                    tok_pos = torch.tensor(
                        [[active[r]["tok"], active[r]["pos"]] for r in rids],
                        dtype=torch.int32).to(self.device)
                    ts = time.perf_counter()
                    if watchdog is not None:
                        watchdog.beat()
                    logits, new_cache = self.decode_vc(
                        variant, self.params,
                        {"tokens": tok_pos[:, :1], "positions": tok_pos[:, 1:]},
                        cache)
                    self._steps["decode"] += 1
                    if watchdog is not None:
                        watchdog.cancel()
                    return pspec, ts, logits, new_cache

                try:
                    pspec, ts, logits, new_cache = _retry("decode_step",
                                                          _decode_round)
                except _StepAbort as err:
                    aborted = err
                    break
                if pspec is not None and pspec.kind == "nan_logits":
                    logits[rids.index(pspec.rid) if pspec.rid in rids else 0] = \
                        float("nan")
                last = logits[:, -1]
                # one transfer: each row's argmax and whether it is finite
                nxt, finite = broadcast_object(torch.stack([
                    last.argmax(dim=-1),
                    torch.isfinite(last.to(torch.float32).amax(dim=-1)).to(torch.long),
                ]).tolist(), self.mesh)
                dt_step = time.perf_counter() - ts
                self.decode_step_latencies.append(dt_step)
                # the first step at each batch size is left out of the
                # tuner's observations, as the reference leaves out its
                # compiling step
                if len(rids) in seen_batches:
                    self._step_lat_by_batch.setdefault(
                        len(rids), deque(maxlen=self.history_window)).append(dt_step)
                seen_batches.add(len(rids))
                manager.absorb(rids, new_cache)
                stats["decode_steps"] += 1
                hit_nan = False
                t_tok = time.perf_counter()
                for i, rid in enumerate(rids):
                    if not finite[i]:
                        _quarantine(rid, "non-finite decode logits")
                        hit_nan = True
                        continue
                    idx0 = len(outputs[rid])
                    outputs[rid].append(nxt[i])
                    active[rid]["tok"] = nxt[i]
                    active[rid]["pos"] += 1
                    rq[rid]["tok_t"].append(t_tok)
                    wavestat["emitted"] += 1
                    _emit("token", rid=rid, token=nxt[i], index=idx0)
                if hit_nan:
                    _audit()

            # wave boundary: one "wave" event carries the batch shape, the
            # operating point in force and this wave's emission / prefill
            # work; the governor observes the same numbers
            dt_wave = time.perf_counter() - t_wave
            _emit("wave", batch=len(rids), dt_s=dt_wave,
                  emitted=wavestat["emitted"],
                  prefill_tokens=wavestat["prefill_tokens"],
                  k=(k_eff if S > 1 else 0),
                  op=(dict(knobs) if gov is not None else None))
            if gov is not None:
                gov.observe_wave(dt_wave, batch=len(rids),
                                 emitted=wavestat["emitted"],
                                 prefill_tokens=wavestat["prefill_tokens"],
                                 wave=wave)
            wave += 1

        if aborted is not None:
            # a step failed past its retry budget: every in-flight request
            # fails *structurally* (partial output kept, pool released)
            for rid in list(active) + list(prefilling):
                outcome[rid] = {"status": "failed",
                                "reason": f"{aborted.point} failed: "
                                          f"{aborted.cause}"}
                fstats["failed"] += 1
                if rid in prefilling:
                    outputs.pop(rid, None)
                _emit("outcome", rid=rid, status="failed",
                      reason=outcome[rid]["reason"],
                      tokens=len(outputs.get(rid, [])))
                _drop(rid)
            while pending:
                waiting.append(pending.popleft())
            while waiting:
                _reject(waiting.popleft(), f"serve aborted at {aborted.point}",
                        status="failed")
        if watchdog is not None:
            fstats["watchdog_timeouts"] = watchdog.timeouts
            watchdog.close()
        _audit()  # final barrier: the drained pools must be consistent

        self.last_pool_stats = manager.stats()
        self.last_pool_stats["grouped_admissions"] = grouped["admissions"]
        self.last_step_counts = dict(self._steps)
        if draft_srv is not self:
            draft_srv.last_step_counts = dict(draft_srv._steps)
        if k_max:
            p = stats["proposed"]
            stats["acceptance"] = stats["accepted"] / p if p else 0.0
            stats["mean_tokens_per_verify"] = (
                stats["emitted_spec"] / stats["request_rounds"]
                if stats["request_rounds"] else 0.0)
            stats["target_steps"] = stats["verify_steps"] + stats["decode_steps"]
            stats["verify_latency_s"] = (
                float(np.mean(verify_lats)) if verify_lats else None)
            self.last_spec_stats = stats
        else:
            self.last_spec_stats = None
        if manager._groups:
            self._paged_dtype = next(iter(manager._groups.values()))["dtype"]
            self._paged_sig = self._paged_signature(
                batch=min(max_batch, len(prompts)), dtype=self._paged_dtype)
        else:
            # every request was rejected before the pool learned its
            # structure: no kernel signature to refine against
            self._paged_dtype = None
            self._paged_sig = None
        injected = list(inj.events[inj_seen:]) if inj is not None else []
        for ev in injected:
            self.broker.publish(f"serve/fault/{ev['point']}/{ev['kind']}@host0", 1.0)
        by_status: dict[str, int] = {}
        for r in range(len(prompts)):
            s = outcome[r]["status"]
            by_status[s] = by_status.get(s, 0) + 1
        self.last_fault_stats = {"events": len(injected),
                                 "injected_events": injected,
                                 "actions": actions,
                                 "outcomes": by_status, **fstats}
        self.last_qos_stats = gov.stats() if gov is not None else None

        def _outcome_row(r):
            m = rq[r]
            row = {"rid": r, "status": outcome[r]["status"],
                   "reason": outcome[r]["reason"],
                   "tokens": len(outputs.get(r, [])[:n]),
                   "ttft_s": None, "ttft_waves": None,
                   "tok_gap_max_s": None}
            if m["first_t"] is not None:
                row["ttft_s"] = m["first_t"] - m["arrive_t"]
                row["ttft_waves"] = m["first_wave"] - m["arrive_wave"]
            tt = m["tok_t"]
            if len(tt) > 1:
                row["tok_gap_max_s"] = max(b - a for a, b in zip(tt, tt[1:]))
            return row

        self.last_outcomes = [_outcome_row(r) for r in range(len(prompts))]
        result = [np.asarray(outputs.get(r, [])[:n], np.int64)
                  for r in range(len(prompts))]
        self._record(t0, len(prompts))
        while evq:
            yield evq.pop(0)
        return result

    # -- the kernel tuner's feedback ----------------------------------------------

    def _paged_signature(self, *, batch: int, dtype):
        """The signature the paged decode steps of this server key on: the
        served KV dtype and the logical cache length the kernel sees (the
        window for ring layouts)."""
        from repro_torch.autotune.kernel_tuner import paged_decode_signature

        cfg = self.woven.program.cfg
        cache_len = self.cfg.max_cache_len
        window = getattr(cfg, "attn_window", None)
        if window is not None and window < cache_len:
            cache_len, window = window, None  # ring layout
        return paged_decode_signature(batch, cache_len, cfg.n_heads, cfg.kv_heads,
                                      cfg.resolved_head_dim, dtype, window=window)

    def refine_kernel_tuner(self, *, latency_budget: float,
                            tuner=None) -> dict | None:
        """Feed observed decode-step latencies back into the persistent
        kernel-tuner cache (`kernel_tuner.refine_from_runtime`, among the
        rows of this server's device): serving traffic refines the DSE
        priors, so the next server picks its page size under observed
        latency.  Returns the re-selected knobs (None if never tuned).  On a
        live mesh rank 0 refines from its own observations and writes the
        cache, and every rank returns rank 0's knobs."""
        from repro_torch.autotune.kernel_tuner import refine_from_runtime

        def refine():
            if self._paged_sig is None or not self._step_lat_by_batch:
                return None
            # continuous batching shrinks the batch as requests retire:
            # observe the best-sampled batch size and refine the signature
            # keyed to it
            batch = max(self._step_lat_by_batch,
                        key=lambda b: len(self._step_lat_by_batch[b]))
            observed = float(np.mean(self._step_lat_by_batch[batch]))
            sig = self._paged_signature(batch=batch, dtype=self._paged_dtype)
            return refine_from_runtime(
                sig, {"latency_s": observed}, tuner=tuner, latency_budget=latency_budget,
                objective_knob="page_size", device=self.device.type)

        return on_rank_zero(refine, self.mesh)

    def refine_speculative(self, *, latency_budget: float,
                           tuner=None) -> dict | None:
        """Feed the observed draft acceptance back into the persistent
        speculative-space entry: the served `mean_tokens_per_verify`
        rescales the cached acceptance-1 `tokens_per_step` priors and the
        verify-step latency the latency expectations, then `draft_len` is
        re-selected under the adjusted budget.  Returns the re-selected
        knobs (None when the last serve was not speculative or never
        tuned).  On a live mesh it is rank 0's, as `refine_kernel_tuner`
        is."""
        from repro_torch.autotune.kernel_tuner import (
            refine_from_runtime,
            speculative_signature,
        )

        def refine():
            stats = self.last_spec_stats
            if not stats or not stats.get("verify_steps"):
                return None
            cfg = self.woven.program.cfg
            cache_len = self.cfg.max_cache_len
            window = getattr(cfg, "attn_window", None)
            if window is not None and window < cache_len:
                cache_len, window = window, None  # ring layout
            batch = max(1, round(stats["request_rounds"] / max(stats["rounds"], 1)))
            sig = speculative_signature(batch, cache_len, cfg.n_heads, cfg.kv_heads,
                                        cfg.resolved_head_dim,
                                        self._paged_dtype or "bfloat16", window=window)
            observed = {"tokens_per_step": float(stats["mean_tokens_per_verify"])}
            if stats.get("verify_latency_s"):
                observed["latency_s"] = float(stats["verify_latency_s"])
            return refine_from_runtime(
                sig, observed, tuner=tuner, latency_budget=latency_budget,
                objective_knob="draft_len", device=self.device.type)

        return on_rank_zero(refine, self.mesh)
