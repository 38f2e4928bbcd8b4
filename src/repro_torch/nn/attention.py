"""Grouped-query attention with KV caches, sliding windows and impl weaving.

Supports what the dense decoder family needs:
  - GQA / MQA / MHA (kv_heads in {1..n_heads}),
  - causal, bidirectional, sliding-window and local masks, optional logit
    soft-capping, QKV bias, RoPE with configurable theta,
  - dense mode (prefill, optionally emitting a KV cache) and decode mode
    (S >= 1 new tokens against a linear or ring cache).

The *implementation* (plain PyTorch vs the hand-written CUDA kernels) is
chosen by the woven Ctx — the ANTAREX code-versioning / kernel-substitution
aspect acting on the attention joinpoint: `ctx.impl("attention", "eager")`
is `"eager"` by default and `"cuda"` once a `KernelAspect` is woven.

Caches are plain dicts of tensors and are **updated in place**: a decode
step writes the new tokens into the `k` / `v` / `pos` tensors it was given
and returns them (the reference donates the buffers to the same effect).
`index` is replaced, never mutated.  Paged caches — `{"pk", "pv"}` page
pools shared by every request, int8 / fp8 ones with `{"ksc", "vsc"}` scale
sidecars, addressed through the model-hoisted `block_tables` — are written
in place the same way, at each token's (page, offset).

Cross-attention, ring page pools (the sliding-window families) and the
meshed KV expansion arrive with the slices that need them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ops import (
    dequantize_kv,
    flash_attention,
    flash_decode,
    kv_scale_from_absmax,
    paged_gather_kv,
    quantize_kv_write,
)
from repro_torch.nn.blocks import apply_rope, rope_angles
from repro_torch.nn.module import Ctx, Module, ParamSpec, cast

NEG_INF = -1e30

_RING_POOLS = ("ring page pools (sliding-window families) are not ported yet: "
               "they arrive with ROADMAP Queue 1 item 10 (mixtral)")


# ---------------------------------------------------------------------------
# KV caches (plain dicts)
# ---------------------------------------------------------------------------


def init_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device="cpu"):
    """Linear cache: slot s holds absolute position s."""
    return {
        "k": torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),  # number of valid tokens
    }


def init_ring_cache(batch: int, window: int, kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16, device="cpu"):
    """Ring cache for windowed attention: slot = pos % window."""
    return {
        "k": torch.zeros((batch, window, kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, kv_heads, head_dim), dtype=dtype, device=device),
        "pos": torch.full((window,), -1, dtype=torch.int32, device=device),  # position per slot
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_spec(batch, max_len, kv_heads, head_dim, dtype=torch.bfloat16, *, ring=False):
    """{leaf: (shape, dtype)} description of one layer's cache."""
    out = {
        "k": ((batch, max_len, kv_heads, head_dim), dtype),
        "v": ((batch, max_len, kv_heads, head_dim), dtype),
        "index": ((), torch.int32),
    }
    if ring:
        out["pos"] = ((max_len,), torch.int32)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch attention math
# ---------------------------------------------------------------------------


def _mask_dense(q_pos, kv_pos, mask_kind: str, window: int | None):
    """(..., S, T) boolean mask from absolute positions."""
    qp = q_pos[..., :, None].to(torch.int32)
    kp = kv_pos[..., None, :].to(torch.int32)
    valid = kp >= 0
    if mask_kind in ("causal", "sliding", "local"):
        valid = valid & (kp <= qp)
    if mask_kind in ("sliding", "local") and window is not None:
        valid = valid & (kp > qp - window)
    return valid


def eager_attention(q, k, v, mask, *, softcap=None, accum_dtype=torch.float32):
    """q:(B,S,H,D) k,v:(B,T,K,D) mask:bool broadcastable to (B,K,G,S,T)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.to(accum_dtype).reshape(B, S, K, G, D)
    kf = k.to(accum_dtype)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, kf) / np.sqrt(D)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    # probabilities drop to v's dtype before P.V, as in the reference
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, D)


def eager_attention_blocked(
    q, k, v, q_pos, kv_pos, *, mask_kind: str, window: int | None,
    softcap=None, block: int = 1024,
):
    """Online-softmax attention, a Python loop over KV blocks.

    Bounds live memory to one (B,K,G,S,block) score tile instead of the full
    (B,K,G,S,T) tensor — the path for long sequences when the CUDA kernel is
    not woven.
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    block = min(block, T)
    qf = (q.to(torch.float32) / np.sqrt(D)).reshape(B, S, K, G, D)
    m = torch.full((B, K, G, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32, device=q.device)
    for start in range(0, T, block):
        k_b = k[:, start:start + block].to(torch.float32)
        v_b = v[:, start:start + block].to(torch.float32)
        p_b = kv_pos[:, start:start + block]
        s = torch.einsum("bskgd,btkd->bkgst", qf, k_b)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        mask = _mask_dense(q_pos, p_b, mask_kind, window)[:, None, None]  # (B,1,1,S,blk)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * mask.to(torch.float32)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p, v_b)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention module
# ---------------------------------------------------------------------------


class Attention(Module):
    kind = "attention"

    def __init__(
        self,
        name: str,
        d_model: int,
        n_heads: int,
        kv_heads: int,
        head_dim: int,
        *,
        bias: bool = False,
        use_rope: bool = True,
        rope_theta: float = 10000.0,
        mask: str = "causal",  # causal | full | sliding | local
        window: int | None = None,
        softcap: float | None = None,
        cross: bool = False,
    ):
        super().__init__()
        if cross:
            raise NotImplementedError(
                "cross-attention is not ported yet (the encoder-decoder slice)")
        self.name = name
        self.d_model = d_model
        self.n_heads, self.kv_heads, self.head_dim = n_heads, kv_heads, head_dim
        self.bias = bias
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.mask = mask
        self.window = window
        self.softcap = softcap
        self.cross = cross

    def spec(self):
        d, H, K, D = self.d_model, self.n_heads, self.kv_heads, self.head_dim
        s: dict[str, Any] = {
            "wq": ParamSpec((d, H * D), ("embed", "heads"), init="scaled", scale=d),
            "wk": ParamSpec((d, K * D), ("embed", "kv_heads"), init="scaled", scale=d),
            "wv": ParamSpec((d, K * D), ("embed", "kv_heads"), init="scaled", scale=d),
            "wo": ParamSpec((H * D, d), ("heads", "embed"), init="scaled", scale=H * D),
        }
        if self.bias:
            s["bq"] = ParamSpec((H * D,), ("heads",), init="zeros")
            s["bk"] = ParamSpec((K * D,), ("kv_heads",), init="zeros")
            s["bv"] = ParamSpec((K * D,), ("kv_heads",), init="zeros")
        return s

    # -- projections -----------------------------------------------------------

    def _proj(self, params, x, which: str, heads: int, policy):
        w = cast(params[f"w{which}"], policy.compute_dtype)
        y = torch.matmul(cast(x, policy.compute_dtype), w)
        if self.bias and which in ("q", "k", "v"):
            y = cast(y, policy.accum_dtype) + cast(params[f"b{which}"], policy.accum_dtype)
        y = cast(y, policy.compute_dtype)
        return y.reshape(*x.shape[:-1], heads, self.head_dim)

    # -- main entry -------------------------------------------------------------

    def forward(
        self,
        params,
        x,
        *,
        ctx: Ctx,
        positions: torch.Tensor | None = None,
        mode: str = "dense",  # dense | prefill | decode
        cache: dict | None = None,
        kv_pos: torch.Tensor | None = None,  # hoisted (B,T) decode positions
        block_tables: torch.Tensor | None = None,  # paged caches: (B, NB) pages
        prefix_len: int = 0,  # paged prefill: shared-prefix slots
        skip_cache_write: bool = False,  # paged re-score: no cache mutation
    ):
        with ctx.scope(self.name):
            policy = ctx.policy()
            B, S, _ = x.shape
            if positions is None:
                positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

            q = self._proj(params, x, "q", self.n_heads, policy)
            q = ctx.constrain(q, ("batch", "seq_act", "heads", None))

            if mode == "decode":
                out, new_cache = self._decode(params, q, x, positions, ctx, policy,
                                              cache, kv_pos, block_tables,
                                              skip_write=skip_cache_write)
            elif mode == "prefill" and cache is not None and "pk" in cache:
                out, new_cache = self._prefill_paged(
                    params, q, x, positions, ctx, policy, cache, block_tables,
                    prefix_len)
            else:
                out, new_cache = self._dense(params, q, x, positions, ctx, policy, mode)

            wo = cast(params["wo"], policy.compute_dtype)
            out = out.reshape(B, S, self.n_heads * self.head_dim)
            if out.dtype != wo.dtype:
                # the plain attention over a dequantized (fp32) pool returns
                # fp32; the product is taken in the promoted type, as the
                # reference's dot of mixed operands is
                dt = torch.promote_types(out.dtype, wo.dtype)
                out, wo = out.to(dt), wo.to(dt)
            y = torch.matmul(out, wo)
            y = cast(y, policy.compute_dtype)
            y = ctx.constrain(y, ("batch", "res_seq", "embed"))
            ctx.tap("out_absmax", lambda: torch.max(torch.abs(y)))
            return y, new_cache

    # -- dense (train / prefill) -------------------------------------------------

    def _dense(self, params, q, x, positions, ctx, policy, mode):
        k = self._proj(params, x, "k", self.kv_heads, policy)
        v = self._proj(params, x, "v", self.kv_heads, policy)
        k = ctx.constrain(k, ("batch", "seq_act", "kv_heads", None))
        v = ctx.constrain(v, ("batch", "seq_act", "kv_heads", None))
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k = apply_rope(k, sin, cos)

        out = self._attend_dense(q, k, v, positions, ctx, policy)

        new_cache = None
        if mode == "prefill":  # the cache stores true KV heads
            new_cache = self._build_cache(k, v, positions, ctx, policy)
        return out, new_cache

    def _attend_dense(self, q, k, v, positions, ctx, policy):
        """Self-aligned (q_pos == kv_pos) attention through the woven impl
        dispatch."""
        S = q.shape[1]
        if self._use_kernel(ctx, q):
            # woven extras win; unset blocks take the kernel's defaults
            blocks = {
                name: int(ctx.extra[key]) if ctx.extra.get(key) is not None
                else None
                for name, key in (("block_q", "flash_block_q"),
                                  ("block_kv", "flash_block_kv"),
                                  ("block_q_bwd", "flash_block_q_bwd"),
                                  ("block_kv_bwd", "flash_block_kv_bwd"))
            }
            out = flash_attention(
                q, k, v,
                causal=self.mask in ("causal", "sliding", "local"),
                window=self.window if self.mask in ("sliding", "local") else None,
                softcap=self.softcap,
                pruned=bool(ctx.extra.get("flash_pruned", True)),
                **blocks,
            )
        else:
            block = int(ctx.extra.get("eager_attn_block", 1024))
            if S > 2 * block:  # long sequences: bounded-memory blocked path
                out = eager_attention_blocked(
                    q, k, v, positions, positions, mask_kind=self.mask,
                    window=self.window, softcap=self.softcap, block=block,
                )
            else:
                mask = _mask_dense(positions, positions, self.mask, self.window)
                mask = mask[:, None, None]  # (B,1,1,S,T)
                out = eager_attention(q, k, v, mask, softcap=self.softcap,
                                      accum_dtype=policy.accum_dtype)
        return out

    def _use_kernel(self, ctx, q) -> bool:
        """Whether the woven impl sends this call to the kernel wrappers.

        On the card `"cuda"` always does: the CUDA kernels take any head_dim
        that is a multiple of 8 up to 256 and raise on anything else, so
        nothing woven to the kernel quietly runs the plain attention.  A CPU
        tensor never launches a kernel; there `_kernel_ok` keeps the
        reference's own gate, so that the two packages take the same branch
        (kernel semantics or plain attention) on the same configuration."""
        if ctx.impl("attention", "eager") != "cuda":
            return False
        return q.is_cuda or self._kernel_ok()

    def _kernel_ok(self) -> bool:
        # the gate the reference applies before its kernels: head_dim 64, 256
        # or a multiple of 128 (the reduced configs' head_dim 16 never
        # reaches a kernel there); no seq-length gate — ragged seq is masked
        # in-kernel.  Consulted for CPU tensors only, see `_use_kernel`.
        if self.head_dim % 128 != 0 and self.head_dim not in (64, 256):
            return False
        return self.n_heads % self.kv_heads == 0

    def _build_cache(self, k, v, positions, ctx, policy):
        """Prefill: pack computed K/V into a cache dict for decode.

        Linear caches are padded to ctx.extra["cache_max_len"] (default: no
        growth room, where the one new token would occupy the final slot).
        """
        B, S = k.shape[0], k.shape[1]
        if self.mask in ("sliding", "local") and self.window is not None and self.window < S:
            W = self.window
            k_w, v_w = k[:, -W:], v[:, -W:]
            pos_w = positions[0, -W:].to(torch.int32)
            slots = (pos_w % W).to(torch.long)
            kc = torch.zeros((B, W, self.kv_heads, self.head_dim), dtype=k.dtype, device=k.device)
            vc = torch.zeros((B, W, self.kv_heads, self.head_dim), dtype=v.dtype, device=v.device)
            kc[:, slots] = k_w
            vc[:, slots] = v_w
            pos = torch.full((W,), -1, dtype=torch.int32, device=k.device)
            pos[slots] = pos_w
            return {"k": kc, "v": vc, "pos": pos,
                    "index": torch.tensor(S, dtype=torch.int32, device=k.device)}
        max_len = int(ctx.extra.get("cache_max_len", S))
        if max_len > S:
            kc = torch.zeros((B, max_len, self.kv_heads, self.head_dim), dtype=k.dtype, device=k.device)
            vc = torch.zeros((B, max_len, self.kv_heads, self.head_dim), dtype=v.dtype, device=v.device)
            kc[:, :S] = k
            vc[:, :S] = v
            k, v = kc, vc
        return {"k": k, "v": v,
                "index": torch.tensor(S, dtype=torch.int32, device=k.device)}

    # -- decode (a block of S >= 1 new tokens against a cache) --------------------

    def _decode(self, params, q, x, positions, ctx, policy, cache, kv_pos=None,
                block_tables=None, skip_write=False):
        """S >= 1 new tokens against a linear, ring or *paged* cache.

        The cache tensors are updated in place and the attention dispatches
        through the same impl-weaving path as `_dense`: `impl == "cuda"`
        streams only the live cache blocks through the `flash_decode`
        kernel; the plain path is kept as the reference.  `cache["index"]`
        may be a scalar (single stream) or per-request (B,) — the
        stacked-serving layout — and ring `pos` follows with shape (W,) or
        (B, W).

        S > 1 writes the whole block of new tokens at slots
        index..index+S-1 and attends it in one widened-q kernel call: token
        s's causal boundary is slot index + s, so the later slots are masked
        exactly as if they were not yet written.  Ring caches are the
        exception: writing token s *evicts* position index+s-W, which earlier
        tokens of the block can still see, so the ring branch unrolls the S
        tokens sequentially.

        Paged caches (`{"pk", "pv"}` pools + the model-hoisted
        `block_tables`) write the new tokens at their physical (page, offset)
        and dispatch the same way (`_decode_paged`).

        Contract: the first new token's `positions` must equal
        `cache["index"]` (tokens are written from that slot).  The kernel
        derives its causal boundary from the index alone, so a caller
        re-scoring an earlier position against a fuller cache must use the
        plain impl, which masks from `positions`/`kv_pos`.
        """
        if cache is None:
            raise ValueError("decode mode requires a cache")
        k_new = self._proj(params, x, "k", self.kv_heads, policy)
        v_new = self._proj(params, x, "v", self.kv_heads, policy)
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k_new = apply_rope(k_new, sin, cos)

        if "pk" in cache:
            return self._decode_paged(q, k_new, v_new, positions, ctx, policy,
                                      cache, kv_pos, block_tables,
                                      skip_write=skip_write)
        if skip_write:
            raise ValueError("skip_cache_write (the re-score step) is a "
                             "paged-cache contract — dense caches decode "
                             "normally")

        S = q.shape[1]
        if "pos" in cache and S > 1:
            # ring eviction: unroll the block token-by-token (see docstring)
            outs = []
            for s in range(S):
                o, cache = self._decode_written(
                    q[:, s:s + 1], k_new[:, s:s + 1], v_new[:, s:s + 1],
                    positions[:, s:s + 1], ctx, policy, cache, None)
                outs.append(o)
            return torch.cat(outs, dim=1), cache
        return self._decode_written(q, k_new, v_new, positions, ctx, policy,
                                    cache, kv_pos)

    def _decode_written(self, q, k_new, v_new, positions, ctx, policy, cache,
                        kv_pos):
        """Write S projected tokens into a dense (linear/ring) cache — in
        place — and attend them: the post-projection body of `_decode`."""
        B, S = q.shape[0], q.shape[1]
        idx = cache["index"]
        per_req = idx.ndim == 1  # stacked multi-request caches
        ring = "pos" in cache
        dev = q.device
        bidx = torch.arange(B, device=dev)
        k_all, v_all = cache["k"], cache["v"]
        k_new = cast(k_new, k_all.dtype)
        v_new = cast(v_new, v_all.dtype)
        if ring:
            if S != 1:
                raise ValueError("ring caches decode one token at a time (unrolled)")
            W = k_all.shape[1]
            slot = (idx % W).to(torch.long)
            pos = cache["pos"]
            if per_req:
                k_all[bidx, slot] = k_new[:, 0]
                v_all[bidx, slot] = v_new[:, 0]
                pos[bidx, slot] = idx  # (B, W)
                kv_pos = pos
            else:
                k_all[:, slot] = k_new[:, 0]
                v_all[:, slot] = v_new[:, 0]
                pos[slot] = idx
                kv_pos = pos.expand(B, W)
            new_cache = {"k": k_all, "v": v_all, "pos": pos, "index": idx + 1}
            kernel_window = None  # the ring layout *is* the window
        else:
            T = k_all.shape[1]
            if per_req:
                # slots index..index+S-1 per request; slots past the end
                # (cache full) are dropped, as the reference's scatter does:
                # they are pointed at their old contents instead
                slots = idx.to(torch.long).reshape(-1, 1) + torch.arange(S, device=dev)
                ok = slots < T
                safe = torch.where(ok, slots, torch.zeros_like(slots))
                rows = bidx[:, None].expand(B, S)
                keep = ok[..., None, None]
                k_all[rows, safe] = torch.where(keep, k_new, k_all[rows, safe])
                v_all[rows, safe] = torch.where(keep, v_new, v_all[rows, safe])
            else:
                # a block that would run past the end is moved back so that
                # it ends at the last slot, as the reference's
                # dynamic_update_slice clamps its start
                start = torch.clamp(idx.to(torch.long), 0, max(T - S, 0))
                span = start + torch.arange(S, device=dev)
                k_all[:, span] = k_new
                v_all[:, span] = v_new
            if kv_pos is None:
                # fallback for single-layer callers; the model hoists this
                # into the cache dict so all layers share one kv_pos
                arange = torch.arange(T, dtype=torch.int32, device=dev)
                last = idx.reshape(-1, 1) + (S - 1)
                kv_pos = torch.where(arange[None] <= last, arange[None],
                                     torch.full_like(arange[None], -1))
                kv_pos = kv_pos.expand(B, T)
            new_cache = {"k": k_all, "v": v_all, "index": idx + S}
            kernel_window = self._kernel_window()

        if self._use_kernel(ctx, q):
            out = flash_decode(q, k_all, v_all, idx, window=kernel_window,
                               **self._decode_kw(ctx))
            return out, new_cache

        mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
        out = eager_attention(q, k_all, v_all, mask, softcap=self.softcap,
                              accum_dtype=policy.accum_dtype)
        return out, new_cache

    def _decode_kw(self, ctx) -> dict:
        """The `flash_decode` options every cache layout shares."""
        blk = ctx.extra.get("flash_block_kv_dec")  # woven extras win
        return {"softcap": self.softcap,
                "block_kv": int(blk) if blk is not None else None,
                "pruned": bool(ctx.extra.get("flash_pruned", True))}

    def _kernel_window(self):
        return self.window if self.mask in ("sliding", "local") else None

    # -- paged pools (K/V live in pages shared by every request) ------------------

    def _prefill_paged(self, params, q, x, positions, ctx, policy, cache,
                       block_tables, prefix_len: int):
        """Prefill one request straight into a page pool: the `prefix_len`
        leading slots are already resident (shared pages the request's block
        table maps), only the non-shared suffix is computed here, and its
        K/V are written in place at the (page, offset) addressing the decode
        path uses — admission never builds a dense max_len cache.

        A quantized pool records each fresh page's scale as the largest
        |K| (|V|) over the tokens this prefill writes into it, per KV head —
        a scatter-max from the 0.0 free-page sentinel (exact whatever the
        order of duplicates) — and quantizes at those fixed scales.  A page
        the shared prefix straddles keeps its donor's scale.

        With no shared prefix the attention is `_attend_dense`, the dense
        prefill's own dispatch (over the *dequantized* values when the pool
        is quantized, so the first logits match every later read of the
        pool) — but a quantized pool under the `cuda` impl attends over its
        codes through the widened-q `flash_decode` kernel at index 0, the
        route and tiling every suffix over a shared prefix takes.  With a
        prefix, the suffix queries attend over the pool-resident K/V:
        through the widened-q `flash_decode` kernel at index = prefix_len
        under the `cuda` impl (the same block walk as the whole prompt's, so
        sharing stays bit-invisible), else through the gathered logical view
        and the plain attention.

        Serving layout only: one request at a time (B = 1).
        """
        if block_tables is None:
            raise ValueError("paged prefill needs block_tables (the model "
                             "hoists cache['block_tables'] to every layer)")
        B, S = q.shape[0], q.shape[1]
        if B != 1:
            raise ValueError("paged prefill packs one request at a time")
        if "pos" in cache:
            raise NotImplementedError(_RING_POOLS)
        k_new = self._proj(params, x, "k", self.kv_heads, policy)
        v_new = self._proj(params, x, "v", self.kv_heads, policy)
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k_new = apply_rope(k_new, sin, cos)

        pk, pv = cache["pk"], cache["pv"]
        ps = pk.shape[1]
        quant = "ksc" in cache
        ksc = vsc = None
        slots = prefix_len + torch.arange(S, device=q.device)
        page = block_tables[0].to(torch.long)[slots // ps]
        off = slots % ps
        if quant:
            ksc, vsc = cache["ksc"], cache["vsc"]
            k_tok = kv_scale_from_absmax(
                k_new[0].to(torch.float32).abs().amax(dim=-1), pk.dtype)  # (S, K)
            v_tok = kv_scale_from_absmax(
                v_new[0].to(torch.float32).abs().amax(dim=-1), pv.dtype)
            if prefix_len % ps:  # the straddled donor page keeps its scale
                keep = (slots // ps == prefix_len // ps)[:, None]
                k_tok = torch.where(keep, torch.zeros_like(k_tok), k_tok)
                v_tok = torch.where(keep, torch.zeros_like(v_tok), v_tok)
            _scatter_max_rows(ksc, page, k_tok)
            _scatter_max_rows(vsc, page, v_tok)
            k_w = quantize_kv_write(k_new[0], ksc[page], pk.dtype)
            v_w = quantize_kv_write(v_new[0], vsc[page], pv.dtype)
        else:
            k_w, v_w = cast(k_new[0], pk.dtype), cast(v_new[0], pv.dtype)
        _write_slots(pk, page, off, k_w)
        _write_slots(pv, page, off, v_w)
        new_cache = {"pk": pk, "pv": pv, "index": cache["index"] + S}
        if quant:
            new_cache["ksc"], new_cache["vsc"] = ksc, vsc

        total = prefix_len + S
        if (prefix_len or quant) and self._use_kernel(ctx, q):
            index = torch.full((B,), prefix_len, dtype=torch.int32, device=q.device)
            out = flash_decode(q, pk, pv, index, window=self._kernel_window(),
                               tables=block_tables, kv_len=total, k_scale=ksc,
                               v_scale=vsc, **self._decode_kw(ctx))
            return out, new_cache
        if prefix_len == 0:
            if quant:
                k_att = dequantize_kv(k_w, ksc[page])[None]
                v_att = dequantize_kv(v_w, vsc[page])[None]
                out = self._attend_dense(q, k_att, v_att, positions, ctx, policy)
            else:
                out = self._attend_dense(q, k_new, v_new, positions, ctx, policy)
            return out, new_cache

        k_log, v_log = paged_gather_kv(pk, pv, block_tables, total,
                                       k_scale=ksc, v_scale=vsc)
        kv_pos = torch.arange(total, dtype=torch.int32, device=q.device).expand(B, total)
        block = int(ctx.extra.get("eager_attn_block", 1024))
        if total > 2 * block:  # long prefixes: bounded-memory blocked path
            out = eager_attention_blocked(
                q, k_log, v_log, positions, kv_pos, mask_kind=self.mask,
                window=self.window, softcap=self.softcap, block=block)
        else:
            mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
            out = eager_attention(q, k_log, v_log, mask, softcap=self.softcap,
                                  accum_dtype=policy.accum_dtype)
        return out, new_cache

    def _decode_paged(self, q, k_new, v_new, positions, ctx, policy, cache,
                      kv_pos, block_tables, skip_write=False):
        """Paged-pool decode: the request's logical slot s lives at
        (tables[b, s // ps], s % ps) of the shared pools; `index` is
        per-request (B,).

        `skip_write=True` is the *re-score* contract (a full-prompt prefix
        hit): the slot at `index` already holds this token's K/V on a shared
        page, so the step computes logits without touching the pool.

        Writes past the logical end (a full cache) are dropped, as the
        reference's scatter drops them: such a slot is pointed at the
        request's last page and keeps its bytes.  A quantized pool records a
        page's scale at its first write (offset 0 — linear slots fill in
        order) and quantizes every later token of the page at that fixed
        scale."""
        if block_tables is None:
            raise ValueError("paged caches need block_tables (the model "
                             "hoists cache['block_tables'] to every layer)")
        idx = cache["index"]
        if idx.ndim != 1:
            raise ValueError("paged caches are per-request: index must be "
                             f"(B,), got shape {tuple(idx.shape)}")
        if "pos" in cache:
            raise NotImplementedError(_RING_POOLS)
        B, S = q.shape[0], q.shape[1]
        pk, pv = cache["pk"], cache["pv"]
        ps = pk.shape[1]
        quant = "ksc" in cache
        ksc, vsc = (cache["ksc"], cache["vsc"]) if quant else (None, None)
        # true logical length: the hoisted kv_pos row width (the table may
        # round up to whole pages); the fallback covers bare callers
        kv_len = (kv_pos.shape[1] if kv_pos is not None
                  else block_tables.shape[1] * ps)
        new_cache = {"pk": pk, "pv": pv, "index": idx if skip_write else idx + S}
        if not skip_write:
            slots = idx.to(torch.long)[:, None] + torch.arange(S, device=q.device)
            ok = slots < kv_len
            # a past-the-end slot points at the request's last page
            blk = torch.clamp(slots // ps, max=block_tables.shape[1] - 1)
            page = torch.gather(block_tables.to(torch.long), 1, blk)  # (B, S)
            off = slots % ps
            if quant:
                k_tok = kv_scale_from_absmax(
                    k_new.to(torch.float32).abs().amax(dim=-1), pk.dtype)  # (B, S, K)
                v_tok = kv_scale_from_absmax(
                    v_new.to(torch.float32).abs().amax(dim=-1), pv.dtype)
                # first write of a page (offset 0) records its scale: a
                # scatter-max from the 0.0 sentinel a fresh page holds
                fresh = ((off == 0) & ok)[..., None]
                _scatter_max_rows(ksc, page, torch.where(fresh, k_tok, torch.zeros_like(k_tok)))
                _scatter_max_rows(vsc, page, torch.where(fresh, v_tok, torch.zeros_like(v_tok)))
                k_w = quantize_kv_write(k_new, ksc[page], pk.dtype)
                v_w = quantize_kv_write(v_new, vsc[page], pv.dtype)
            else:
                k_w, v_w = cast(k_new, pk.dtype), cast(v_new, pv.dtype)
            _write_slots(pk, page, off, k_w, keep=ok)
            _write_slots(pv, page, off, v_w, keep=ok)
        if quant:
            new_cache["ksc"], new_cache["vsc"] = ksc, vsc
        if kv_pos is None:
            arange = torch.arange(kv_len, dtype=torch.int32, device=q.device)
            last = idx.reshape(-1, 1) + (S - 1)
            kv_pos = torch.where(arange[None] <= last, arange[None],
                                 torch.full_like(arange[None], -1))

        if self._use_kernel(ctx, q):
            out = flash_decode(q, pk, pv, idx, window=self._kernel_window(),
                               tables=block_tables, kv_len=kv_len, k_scale=ksc,
                               v_scale=vsc, **self._decode_kw(ctx))
            return out, new_cache

        # plain path: gather the logical view through the table, then the
        # dense decode math, masked from the caller's positions
        k_log, v_log = paged_gather_kv(pk, pv, block_tables, kv_len,
                                       k_scale=ksc, v_scale=vsc)
        mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
        out = eager_attention(q, k_log, v_log, mask, softcap=self.softcap,
                              accum_dtype=policy.accum_dtype)
        return out, new_cache


def _scatter_max_rows(scales, page, tok):
    """scales[page[i]] = max(scales[page[i]], tok[i]), in place: (P, K)
    sidecar rows against (..., K) per-token scales at (...) pages.  Max does
    not depend on the order of duplicate pages, so this is exact."""
    K = scales.shape[-1]
    scales.scatter_reduce_(0, page.reshape(-1, 1).expand(-1, K),
                           tok.reshape(-1, K), "amax", include_self=True)


def _write_slots(pool, page, off, new, keep=None):
    """pool[page, off] = new, in place; where `keep` is False the slot keeps
    its bytes.  One-byte codes are moved as int8 bytes."""
    if pool.element_size() == 1:
        pool, new = pool.view(torch.int8), new.view(torch.int8)
    if keep is not None:
        new = torch.where(keep[..., None, None], new, pool[page, off])
    pool[page, off] = new
