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
is `"eager"` by default and `"cuda"` once a `KernelAspect` is woven;
the roofline's components weave `"proj_only"`, which keeps the projections
and skips the S x T core of a self-aligned (dense / prefill) attention.

Caches are plain dicts of tensors and are **updated in place**: a decode
step writes the new tokens into the `k` / `v` / `pos` tensors it was given
and returns them (the reference donates the buffers to the same effect).
`index` is replaced, never mutated.  Paged caches — `{"pk", "pv"}` page
pools shared by every request, int8 / fp8 ones with `{"ksc", "vsc"}` scale
sidecars, addressed through the model-hoisted `block_tables` — are written
in place the same way, at each token's (page, offset).

Ring page pools — the pools of a sliding-window model whose prompts pass its
window — keep a request's last W tokens at slot = position % W of its block
table, with a per-request `pos` row saying which position each slot holds.

Cross-attention (`cross=True`, whisper's decoder) attends over K/V projected
from an encoder's states (`kv_src`); its `{"ck", "cv"}` cache is computed
once and never written.

On a live mesh (`launch/mesh.make_mesh`) the module holds its rank's blocks
of the projections: H / tp q heads, and the KV heads those q heads read.
Where the KV heads divide the `model` axis these are the rank's own block;
where they do not (gemma-2b's one KV head on two ranks, AutoShard's
`expand_kv`) the K / V projections are gathered over `model` and each rank
keeps the heads its q heads read (`_maybe_expand_kv`).  The kernels run on
these local tensors, and the output projection's partial products add over
`model`.

Under `fsdp_sp` (`sharding.seq_axis`) a rank holds its block of the
sequence and the whole weights (FSDP-gathered by the model).  Attention
gathers q / k / v over the sequence axis, runs on the whole sequence of the
rank's rows (K1 with its lse, K3 in the backward) and keeps the rank's
block of the output, as the reference's `shard_map` does where the heads do
not divide `model`: there q is replicated over `model` on the whole
sequence.  Cross-attention's q is the rank's block of decoder tokens and
its K / V come from the whole encoder output (`models/encdec.py` gathers
it once over the axis): its output is the rank's block as it stands.

Serving under `fsdp_sp` (`sharding.kv_seq_axis`) a rank holds its share of
every cache's sequence (`sharding.seq_share`): the block [r T/n, (r+1) T/n)
of a dense cache of T slots (a ring's W), the slots [r ps/n, (r+1) ps/n)
of every page of a pool — where n divides T (ps), else the whole cache.  A
prefill gathers the prompt's K / V and keeps (writes) the rank's slots; a
decode step's tokens are whole on every rank and each is written by the
rank that holds its slot.  Every attention over a cache runs over the
rank's slots alone — `flash_decode`'s block mode, or the plain attention
with its lse (`eager_attention_lse`) — and the ranks' (o, lse) are merged
in rank order (`collectives.combine_attention`).  The hoisted `kv_pos`
(and `page_size`) give a cache's whole length (a page's).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.distributed.collectives import (all_gather, combine_attention, copy_to,
                                                gather_from)
from repro_torch.distributed.sharding import kv_seq_axis, seq_axis, seq_share
from repro_torch.kernels.flash_attention.decode import share_count, share_slots
from repro_torch.kernels.flash_attention.ops import (
    dequantize_kv,
    flash_attention,
    flash_decode,
    kv_scale_from_absmax,
    local_kv_heads,
    paged_gather_kv,
    quantize_kv_write,
)
from repro_torch.launch.mesh import is_parallel
from repro_torch.nn.blocks import apply_rope, row_parallel_matmul, rope_angles
from repro_torch.nn.module import Ctx, Module, ParamSpec, cast

NEG_INF = -1e30


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


def eager_attention_lse(q, k, v, mask, *, softcap=None, accum_dtype=torch.float32):
    """`eager_attention` over a rank's share of the keys, for the ranks'
    merge (`collectives.combine_attention`): (o, lse), o (B, S, H, D) fp32
    normalised over the share (probabilities dropped to v's dtype before
    P.V, as `eager_attention` drops them) and lse = m + log l (B, S, H)
    fp32, -inf (and o = 0) where a row sees none of the share's keys."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.to(accum_dtype).reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(accum_dtype)) / np.sqrt(D)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF)).to(torch.float32)
    live = mask.expand_as(scores)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m) * live.to(torch.float32)
    l = torch.sum(p, dim=-1, keepdim=True)
    probs = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, -np.inf))[..., 0]  # (B, K, G, S)
    return (out.reshape(B, S, H, D).to(torch.float32),
            lse.permute(0, 3, 1, 2).reshape(B, S, H))


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

    def _proj_flat(self, params, x, which: str, policy):
        """x @ w{which} (+ b), flat: (..., the weight block's columns)."""
        w = cast(params[f"w{which}"], policy.compute_dtype)
        y = torch.matmul(cast(x, policy.compute_dtype), w)
        if self.bias and which in ("q", "k", "v"):
            y = cast(y, policy.accum_dtype) + cast(params[f"b{which}"], policy.accum_dtype)
        return cast(y, policy.compute_dtype)

    def _proj(self, params, x, which: str, heads: int, policy):
        """The projection as (..., heads, head_dim): the layer's `heads`, or
        on a live mesh the fewer that the rank's block of the weight holds."""
        y = self._proj_flat(params, x, which, policy)
        return y.reshape(*x.shape[:-1], -1, self.head_dim)

    def _kv_proj(self, params, x, policy, ctx):
        """The K / V heads this rank's q heads read (all of them off a mesh)."""
        if not is_parallel(ctx.mesh, "model"):
            return (self._proj(params, x, "k", self.kv_heads, policy),
                    self._proj(params, x, "v", self.kv_heads, policy))
        k = self._proj_flat(params, x, "k", policy)
        v = self._proj_flat(params, x, "v", policy)
        return self._maybe_expand_kv(k, v, params, ctx)

    def _maybe_expand_kv(self, k, v, params, ctx):
        """Megatron's layout on a live mesh: the KV heads each local q head
        reads.  Where the KV heads divide `model` a rank's block of wk / wv
        gives exactly those; where they do not (AutoShard's `expand_kv`),
        the projections are gathered over `model` (a block of wk may split
        a head) and each rank keeps the heads of its q heads — one per
        group, or one per q head where the groups straddle ranks, as the
        reference's meshed `take` does.  k, v: (B, S, cols) flat."""
        K, D = self.kv_heads, self.head_dim
        h_loc = params["wq"].shape[-1] // D
        tp = self.n_heads // h_loc  # 1 where the q heads are whole
        if K % tp == 0:  # all KV heads, or the rank's own block of them
            return (k.reshape(*k.shape[:-1], K // tp, D),
                    v.reshape(*v.shape[:-1], K // tp, D))
        if k.shape[-1] != K * D:
            k = gather_from(k, ctx.mesh, "model", -1)
            v = gather_from(v, ctx.mesh, "model", -1)
        idx = local_kv_heads(self.n_heads, K, ctx.mesh.coord("model") * h_loc, h_loc)
        sel = torch.tensor(idx, dtype=torch.long, device=k.device)
        k = k.reshape(*k.shape[:-1], K, D).index_select(-2, sel)
        v = v.reshape(*v.shape[:-1], K, D).index_select(-2, sel)
        return k, v

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
        kv_src: torch.Tensor | None = None,  # cross-attention source (B,T,d)
        kv_pos: torch.Tensor | None = None,  # hoisted (B,T) decode positions
        block_tables: torch.Tensor | None = None,  # paged caches: (B, NB) pages
        prefix_len: int = 0,  # paged prefill: shared-prefix slots
        skip_cache_write: bool = False,  # paged re-score: no cache mutation
        page_size: int | None = None,  # paged caches: a page's slots (all ranks')
    ):
        with ctx.scope(self.name):
            policy = ctx.policy()
            B, S, _ = x.shape
            if positions is None:
                positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

            if params["wq"].shape[-1] != self.n_heads * self.head_dim:
                x = copy_to(x, ctx.mesh, "model")  # column-parallel q / k / v
            q = self._proj(params, x, "q", self.n_heads, policy)
            q = ctx.constrain(q, ("batch", "seq_act", "heads", None))

            if self.cross:
                out, new_cache = self._cross(params, q, ctx, policy, cache,
                                             kv_src, mode)
            elif mode == "decode":
                out, new_cache = self._decode(params, q, x, positions, ctx, policy,
                                              cache, kv_pos, block_tables,
                                              skip_write=skip_cache_write,
                                              page_size=page_size)
            elif mode == "prefill" and cache is not None and "pk" in cache:
                out, new_cache = self._prefill_paged(
                    params, q, x, positions, ctx, policy, cache, block_tables,
                    prefix_len, page_size)
            else:
                out, new_cache = self._dense(params, q, x, positions, ctx, policy, mode)

            wo = cast(params["wo"], policy.compute_dtype)
            out = out.reshape(B, S, -1)
            if out.dtype != wo.dtype:
                # the plain attention over a dequantized (fp32) pool returns
                # fp32; the product is taken in the promoted type, as the
                # reference's dot of mixed operands is
                dt = torch.promote_types(out.dtype, wo.dtype)
                out, wo = out.to(dt), wo.to(dt)
            if wo.shape[-2] != self.n_heads * self.head_dim:  # row-parallel
                y = row_parallel_matmul(out, wo, ctx)
            else:
                y = torch.matmul(out, wo)
            y = cast(y, policy.compute_dtype)
            y = ctx.constrain(y, ("batch", "res_seq", "embed"))
            ctx.tap("out_absmax", lambda: torch.max(torch.abs(y)))
            return y, new_cache

    # -- dense (train / prefill) -------------------------------------------------

    def _dense(self, params, q, x, positions, ctx, policy, mode):
        k, v = self._kv_proj(params, x, policy, ctx)
        k = ctx.constrain(k, ("batch", "seq_act", "kv_heads", None))
        v = ctx.constrain(v, ("batch", "seq_act", "kv_heads", None))
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k = apply_rope(k, sin, cos)

        sp = seq_axis(ctx.mesh, ctx.rules)
        if sp is None:
            out = self._attend_dense(q, k, v, positions, ctx, policy)
        else:  # fsdp_sp: the whole sequence, then this rank's block of it
            S = q.shape[1]
            q, k, v = (gather_from(t, ctx.mesh, sp, 1) for t in (q, k, v))
            positions = all_gather(positions, ctx.mesh, sp, 1)
            out = self._attend_dense(q, k, v, positions, ctx, policy)
            out = out.narrow(1, ctx.mesh.coord(sp) * S, S)

        new_cache = None
        if mode == "prefill":  # the cache stores true KV heads
            new_cache = self._build_cache(k, v, positions, ctx, policy)
        return out, new_cache

    def _attend_dense(self, q, k, v, positions, ctx, policy):
        """Self-aligned (q_pos == kv_pos) attention through the woven impl
        dispatch."""
        S = q.shape[1]
        if ctx.impl("attention", "eager") == "proj_only":
            # roofline component mode (`roofline/components.py`): keep the
            # projections, tie k and v into the output so they stay live,
            # and skip the S x T core, which is costed analytically
            return q + (torch.mean(k, dim=2, keepdim=True)
                        + torch.mean(v, dim=2, keepdim=True)).to(q.dtype)
        if self._use_kernel(ctx, q):
            # woven extras win; unset knobs take the tuner's or the kernel's
            blocks = {
                name: int(ctx.extra[key]) if ctx.extra.get(key) is not None
                else None
                for name, key in (("block_q", "flash_block_q"),
                                  ("block_kv", "flash_block_kv"),
                                  ("block_q_bwd", "flash_block_q_bwd"),
                                  ("block_kv_bwd", "flash_block_kv_bwd"),
                                  ("dkv_n_split", "flash_dkv_n_split"))
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
        """Prefill: pack computed K/V (the whole prompt's) into a cache dict
        for decode.

        Linear caches are padded to ctx.extra["cache_max_len"] (default: no
        growth room, where the one new token would occupy the final slot).
        Under a sequence split of the caches (`sharding.seq_share` of the
        cache's length) the rank keeps its block of the slots (of a ring's
        too; its `pos` map stays whole).
        """
        B, S = k.shape[0], k.shape[1]
        if self.mask in ("sliding", "local") and self.window is not None and self.window < S:
            W = self.window
            k_w, v_w = k[:, -W:], v[:, -W:]
            pos_w = positions[0, -W:].to(torch.int32)
            slots = (pos_w % W).to(torch.long)
            pos = torch.full((W,), -1, dtype=torch.int32, device=k.device)
            pos[slots] = pos_w
            share = self._share(ctx, W)
            n = share[0] if share else W
            if share:  # the rank's block of the ring's slots
                own = (slots >= share[2]) & (slots < share[2] + n)
                k_w, v_w, slots = k_w[:, own], v_w[:, own], slots[own] - share[2]
            kc = torch.zeros((B, n, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros((B, n, *v.shape[2:]), dtype=v.dtype, device=v.device)
            kc[:, slots] = k_w
            vc[:, slots] = v_w
            return {"k": kc, "v": vc, "pos": pos,
                    "index": torch.tensor(S, dtype=torch.int32, device=k.device)}
        max_len = int(ctx.extra.get("cache_max_len", S))
        share = self._share(ctx, max(max_len, S))
        if share:  # the rank's block [phase, phase + sub) of the slots
            sub, _, phase = share
            kc = torch.zeros((B, sub, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros((B, sub, *v.shape[2:]), dtype=v.dtype, device=v.device)
            n = max(0, min(S - phase, sub))
            kc[:, :n] = k[:, phase:phase + n]
            vc[:, :n] = v[:, phase:phase + n]
            return {"k": kc, "v": vc,
                    "index": torch.tensor(S, dtype=torch.int32, device=k.device)}
        if max_len > S:
            kc = torch.zeros((B, max_len, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros((B, max_len, *v.shape[2:]), dtype=v.dtype, device=v.device)
            kc[:, :S] = k
            vc[:, :S] = v
            k, v = kc, vc
        return {"k": k, "v": v,
                "index": torch.tensor(S, dtype=torch.int32, device=k.device)}

    # -- decode (a block of S >= 1 new tokens against a cache) --------------------

    def _decode(self, params, q, x, positions, ctx, policy, cache, kv_pos=None,
                block_tables=None, skip_write=False, page_size=None):
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
        k_new, v_new = self._kv_proj(params, x, policy, ctx)
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k_new = apply_rope(k_new, sin, cos)

        if "pk" in cache:
            return self._decode_paged(q, k_new, v_new, positions, ctx, policy,
                                      cache, kv_pos, block_tables,
                                      skip_write=skip_write, page_size=page_size)
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
        place — and attend them: the post-projection body of `_decode`.

        Under a sequence split of the caches the cache holds the rank's
        block of the slots (`sharding.seq_share` of the ring's W, or of the
        linear cache's T — the hoisted `kv_pos`'s width): a token is written
        by the rank that holds its slot, every rank attends its block and
        the ranks' partials are merged (`_merge`)."""
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
            pos = cache["pos"]
            W = pos.shape[-1]
            share = self._cache_share(ctx, W, k_all.shape[1])
            slot = (idx % W).to(torch.long)
            if per_req:
                _write_rows(k_all, v_all, bidx, slot, k_new[:, 0], v_new[:, 0], share)
                pos[bidx, slot] = idx  # (B, W)
                kv_pos = pos
            else:
                # a one-element index, not a 0-dim one: indexing by a 0-dim
                # tensor reads it on the host (a sync on the card, and
                # impossible on the meta device the roofline costs on)
                one = slot.reshape(1)
                _write_rows(k_all, v_all, slice(None), one, k_new, v_new, share)
                pos[one] = idx.reshape(1)
                kv_pos = pos.expand(B, W)
            new_cache = {"k": k_all, "v": v_all, "pos": pos, "index": idx + 1}
            kernel_window = None  # the ring layout *is* the window
        else:
            share = self._cache_share(
                ctx, kv_pos.shape[1] if kv_pos is not None else k_all.shape[1],
                k_all.shape[1], hoisted=kv_pos is not None)
            T = share[1] if share else k_all.shape[1]  # the whole cache's slots
            if per_req:
                # slots index..index+S-1 per request; slots past the end
                # (cache full) are dropped, as the reference's scatter does:
                # they are pointed at their old contents instead
                slots = idx.to(torch.long).reshape(-1, 1) + torch.arange(S, device=dev)
                ok = slots < T
                safe = torch.where(ok, slots, torch.zeros_like(slots))
                rows = bidx[:, None].expand(B, S)
                if share is None:
                    keep = ok[..., None, None]
                    k_all[rows, safe] = torch.where(keep, k_new, k_all[rows, safe])
                    v_all[rows, safe] = torch.where(keep, v_new, v_all[rows, safe])
                else:
                    for s in range(S):  # one token a request at a time: no slot twice
                        _write_rows(k_all, v_all, bidx, safe[:, s], k_new[:, s],
                                    v_new[:, s], share, keep=ok[:, s])
            else:
                # a block that would run past the end is moved back so that
                # it ends at the last slot, as the reference's
                # dynamic_update_slice clamps its start
                start = torch.clamp(idx.to(torch.long), 0, max(T - S, 0))
                span = start + torch.arange(S, device=dev)
                if share is None:
                    k_all[:, span] = k_new
                    v_all[:, span] = v_new
                else:
                    for s in range(S):
                        _write_rows(k_all, v_all, slice(None), span[s:s + 1],
                                    k_new[:, s:s + 1], v_new[:, s:s + 1], share)
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
                               **self._decode_kw(ctx, share))
            return self._merge(out, ctx, q.dtype, share), new_cache

        if share is not None:  # the positions the rank's slots hold
            kv_pos = kv_pos[:, share[2]:share[2] + share[0]]
        mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
        out = self._eager(q, k_all, v_all, mask, policy, share)
        return self._merge(out, ctx, v_all.dtype, share), new_cache

    # -- a rank's share of sequence-split caches --------------------------------------

    def _share(self, ctx, length: int):
        """(sub, span, phase): the rank's share of a cache dim of `length`
        slots under a sequence split, or None where the dim stays whole."""
        return seq_share(ctx.mesh, ctx.rules, int(length))

    def _cache_share(self, ctx, length: int, held: int, hoisted: bool = True):
        """`_share` of a cache whose whole length is `length` and whose rank
        holds `held` slots, checked against them (None off a sequence
        split)."""
        if kv_seq_axis(ctx.mesh, ctx.rules) is None:
            return None
        if not hoisted:
            raise ValueError("a sequence-split linear cache decodes with the "
                             "model's hoisted kv_pos (its whole length)")
        share = self._share(ctx, length)
        if held != (share[0] if share else length):
            raise ValueError(f"the cache holds {held} slots of {length}: the rank's "
                             f"share is {share}")
        return share

    def _eager(self, q, k, v, mask, policy, share):
        """The plain attention: the whole cache's, or a rank's share's
        (o, lse) for the merge."""
        if share is None:
            return eager_attention(q, k, v, mask, softcap=self.softcap,
                                   accum_dtype=policy.accum_dtype)
        return eager_attention_lse(q, k, v, mask, softcap=self.softcap,
                                   accum_dtype=policy.accum_dtype)

    @staticmethod
    def _merge(out, ctx, dtype, share):
        """A whole cache's output as it is; a share's (o, lse) merged over
        the split axis (`collectives.combine_attention`), rounded to
        `dtype` once."""
        if share is None:
            return out
        o, lse = out
        return combine_attention(o, lse, ctx.mesh, kv_seq_axis(ctx.mesh, ctx.rules)).to(dtype)

    def _decode_kw(self, ctx, share=None) -> dict:
        """The `flash_decode` options every cache layout shares, and a rank's
        share of the cache's slots where it holds one (`block`)."""
        blk = ctx.extra.get("flash_block_kv_dec")  # woven extras win
        kw = {"softcap": self.softcap,
              "block_kv": int(blk) if blk is not None else None,
              "pruned": bool(ctx.extra.get("flash_pruned", True))}
        if share is not None:
            kw["block"] = share
        return kw

    def _kernel_window(self):
        return self.window if self.mask in ("sliding", "local") else None

    # -- paged pools (K/V live in pages shared by every request) ------------------

    def _prefill_paged(self, params, q, x, positions, ctx, policy, cache,
                       block_tables, prefix_len: int, page_size=None):
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

        Under a sequence split of the pools (`sharding.seq_share` of
        `page_size`, every rank's page slots) the rank's pool holds its
        slots of every page: the suffix's tokens are gathered whole (where
        the prompt is split over the ranks), each rank writes the tokens its
        slots hold, a quantized page's scale is taken from all the tokens
        written to the page (every rank has them, so the scales are equal on
        every rank), and an attention over the pool attends the rank's
        slots and merges the ranks' partials.

        Serving layout only: one request at a time (B = 1).
        """
        if block_tables is None:
            raise ValueError("paged prefill needs block_tables (the model "
                             "hoists cache['block_tables'] to every layer)")
        B, S = q.shape[0], q.shape[1]
        if B != 1:
            raise ValueError("paged prefill packs one request at a time")
        k_new, v_new = self._kv_proj(params, x, policy, ctx)
        if self.use_rope:
            sin, cos = rope_angles(positions, self.head_dim, self.rope_theta)
            q = apply_rope(q, sin, cos)
            k_new = apply_rope(k_new, sin, cos)
        sp = seq_axis(ctx.mesh, ctx.rules)
        if sp is not None:  # the prompt split over the ranks: all of it, then our block
            q, k_new, v_new = (all_gather(t, ctx.mesh, sp, 1) for t in (q, k_new, v_new))
            positions = all_gather(positions, ctx.mesh, sp, 1)
        out, new_cache = self._prefill_paged_whole(q, k_new, v_new, positions, ctx,
                                                   policy, cache, block_tables,
                                                   prefix_len, page_size)
        if sp is not None:
            out = out.narrow(1, ctx.mesh.coord(sp) * S, S)
        return out, new_cache

    def _prefill_paged_whole(self, q, k_new, v_new, positions, ctx, policy, cache,
                             block_tables, prefix_len, page_size):
        """`_prefill_paged` on the whole suffix (see there)."""
        B, S = q.shape[0], q.shape[1]
        pk, pv = cache["pk"], cache["pv"]
        ps = int(page_size or pk.shape[1])
        share = self._pool_share(ctx, ps, pk.shape[1])
        if "pos" in cache:
            # a ring pool never shares a prefix (slot contents depend on the
            # wrap), so the whole prompt is here: keep its last W tokens at
            # slot = position % W — `_build_cache`'s ring packing, addressed
            # through the block table — and attend over the whole prompt
            W = cache["pos"].shape[-1]
            keep = min(W, S)
            pos_w = positions[0, -keep:].to(torch.int32)
            slots = (pos_w % W).to(torch.long)
            page = block_tables[0].to(torch.long)[slots // ps]
            off = slots % ps
            _write_share(pk, page, off, cast(k_new[0, -keep:], pk.dtype), share,
                         one_request=True)
            _write_share(pv, page, off, cast(v_new[0, -keep:], pv.dtype), share,
                         one_request=True)
            pos = torch.full((W,), -1, dtype=torch.int32, device=q.device)
            pos[slots] = pos_w
            new_cache = {"pk": pk, "pv": pv, "pos": pos, "index": cache["index"] + S}
            out = self._attend_dense(q, k_new, v_new, positions, ctx, policy)
            return out, new_cache
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
        _write_share(pk, page, off, k_w, share, one_request=True)
        _write_share(pv, page, off, v_w, share, one_request=True)
        new_cache = {"pk": pk, "pv": pv, "index": cache["index"] + S}
        if quant:
            new_cache["ksc"], new_cache["vsc"] = ksc, vsc

        total = prefix_len + S
        if (prefix_len or quant) and self._use_kernel(ctx, q):
            index = torch.full((B,), prefix_len, dtype=torch.int32, device=q.device)
            out = flash_decode(q, pk, pv, index, window=self._kernel_window(),
                               tables=block_tables, kv_len=total, k_scale=ksc,
                               v_scale=vsc, **self._decode_kw(ctx, share))
            return self._merge(out, ctx, q.dtype, share), new_cache
        if prefix_len == 0:
            if quant:
                k_att = dequantize_kv(k_w, ksc[page])[None]
                v_att = dequantize_kv(v_w, vsc[page])[None]
                out = self._attend_dense(q, k_att, v_att, positions, ctx, policy)
            else:
                out = self._attend_dense(q, k_new, v_new, positions, ctx, policy)
            return out, new_cache

        n = total if share is None else share_count(total - 1, share)
        k_log, v_log = paged_gather_kv(pk, pv, block_tables, n,
                                       k_scale=ksc, v_scale=vsc)
        # the position each slot holds: the slot itself, or the cache slot
        # the rank's slot holds
        slots = torch.arange(n, device=q.device) if share is None else \
            share_slots(n, share, q.device)
        kv_pos = slots.to(torch.int32)[None].expand(B, n)
        block = int(ctx.extra.get("eager_attn_block", 1024))
        if share is None and total > 2 * block:  # long prefixes: bounded-memory blocked path
            out = eager_attention_blocked(
                q, k_log, v_log, positions, kv_pos, mask_kind=self.mask,
                window=self.window, softcap=self.softcap, block=block)
            return out, new_cache
        mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
        out = self._eager(q, k_log, v_log, mask, policy, share)
        return self._merge(out, ctx, v_log.dtype, share), new_cache

    def _pool_share(self, ctx, page_size: int, held: int):
        """`_share` of a page pool's pages of `page_size` slots, whose rank
        holds `held` slots of each, checked against them (None off a
        sequence split)."""
        if kv_seq_axis(ctx.mesh, ctx.rules) is None:
            return None
        share = self._share(ctx, page_size)
        if held != (share[0] if share else page_size):
            raise ValueError(f"the pool holds {held} slots of pages of {page_size}: "
                             f"the rank's share is {share}")
        return share

    def _decode_paged(self, q, k_new, v_new, positions, ctx, policy, cache,
                      kv_pos, block_tables, skip_write=False, page_size=None):
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
        scale.

        A ring pool (`pos` in the cache: a sliding window the prompt has
        passed) decodes one token at a time: it is written at slot =
        index % W, evicting the position W back, its `pos` entry set, and
        the kernel walks all W slots with no window (the ring layout is the
        window).  Ring pools never share, so a re-score never reaches one.

        Under a sequence split of the pools (`_prefill_paged`) a token is
        written by the rank whose slots hold it (every rank records a fresh
        page's scale from the whole token), and every rank attends its
        slots and merges the ranks' partials."""
        if block_tables is None:
            raise ValueError("paged caches need block_tables (the model "
                             "hoists cache['block_tables'] to every layer)")
        idx = cache["index"]
        if idx.ndim != 1:
            raise ValueError("paged caches are per-request: index must be "
                             f"(B,), got shape {tuple(idx.shape)}")
        pk, pv = cache["pk"], cache["pv"]
        ps = int(page_size or pk.shape[1])
        share = self._pool_share(ctx, ps, pk.shape[1])
        if "pos" in cache:
            return self._decode_ring_paged(q, k_new, v_new, positions, ctx, policy,
                                           cache, block_tables, skip_write, ps, share)
        B, S = q.shape[0], q.shape[1]
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
            _write_share(pk, page, off, k_w, share, keep=ok)
            _write_share(pv, page, off, v_w, share, keep=ok)
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
                               v_scale=vsc, **self._decode_kw(ctx, share))
            return self._merge(out, ctx, q.dtype, share), new_cache

        # plain path: gather the logical view through the table (the
        # rank's slots of it under a share), then the dense decode math,
        # masked from the caller's positions
        n = kv_len if share is None else share_count(kv_len - 1, share)
        k_log, v_log = paged_gather_kv(pk, pv, block_tables, n,
                                       k_scale=ksc, v_scale=vsc)
        if share is not None:
            kv_pos = kv_pos[:, share_slots(n, share, q.device)]
        mask = _mask_dense(positions, kv_pos, self.mask, self.window)[:, None, None]
        out = self._eager(q, k_log, v_log, mask, policy, share)
        return self._merge(out, ctx, v_log.dtype, share), new_cache

    def _decode_ring_paged(self, q, k_new, v_new, positions, ctx, policy, cache,
                           block_tables, skip_write, ps, share):
        """`_decode_paged` over a ring pool (see there)."""
        if q.shape[1] > 1:
            raise ValueError("ring pools decode one token at a time (eviction "
                             "breaks the widened-q mask); the server gates "
                             "speculative decoding to linear pools")
        if skip_write:
            raise ValueError("re-score is a linear prefix-shared contract — "
                             "ring pools never share")
        idx = cache["index"]
        pk, pv, pos = cache["pk"], cache["pv"], cache["pos"]
        W = pos.shape[-1]
        bidx = torch.arange(q.shape[0], device=q.device)
        slot = (idx % W).to(torch.long)
        page = block_tables.to(torch.long)[bidx, slot // ps]
        off = slot % ps
        _write_share(pk, page, off, cast(k_new[:, 0], pk.dtype), share)
        _write_share(pv, page, off, cast(v_new[:, 0], pv.dtype), share)
        pos[bidx, slot] = idx.to(pos.dtype)
        new_cache = {"pk": pk, "pv": pv, "pos": pos, "index": idx + 1}

        if self._use_kernel(ctx, q):
            # the ring layout *is* the window: the walk covers all W slots
            out = flash_decode(q, pk, pv, idx, window=None, tables=block_tables,
                               kv_len=W, **self._decode_kw(ctx, share))
            return self._merge(out, ctx, q.dtype, share), new_cache

        # plain path: the logical ring view through the table, masked by
        # the position each slot holds
        n = W if share is None else share_count(W - 1, share)
        k_log, v_log = paged_gather_kv(pk, pv, block_tables, n)
        held = pos if share is None else pos[:, share_slots(n, share, q.device)]
        mask = _mask_dense(positions, held, self.mask, self.window)[:, None, None]
        out = self._eager(q, k_log, v_log, mask, policy, share)
        return self._merge(out, ctx, v_log.dtype, share), new_cache

    # -- cross attention (whisper decoder) ----------------------------------------

    def _cross(self, params, q, ctx, policy, cache, kv_src, mode="dense"):
        """Cross-attention over the (fixed-length) encoder states.

        Without a cache, K and V are projected from `kv_src` and returned as
        the `{"ck", "cv"}` cache; handed one, the cache comes back as the
        same object and is never written.  On a live mesh the cache holds
        the KV heads of the rank's q heads; under `fsdp_sp` q is the rank's
        block of tokens and `kv_src` the whole encoder output, entering the
        whole K / V projections (the `copy_to` below is Megatron's column
        split's alone), and the cache keeps the rank's block of the frames
        where the sequence axis divides them (`sharding.seq_share`): a
        decode step attends the rank's frames and merges the ranks'
        partials.  A single-token decode step under
        the `cuda` impl attends through `flash_decode` at `index = T - 1`:
        the encoder length is fixed, so every slot is live and the causal
        bound of the last slot is the full mask.  Every multi-token call
        (prefill, dense) takes the plain attention, as in the reference:
        no kernel runs there."""
        share = None
        if cache is not None and "ck" in cache:
            k, v = cache["ck"], cache["cv"]
            new_cache = cache
            T = kv_src.shape[1] if kv_src is not None else k.shape[1]
            share = self._cache_share(ctx, T, k.shape[1])
        else:
            if kv_src is None:
                raise ValueError("cross-attention needs kv_src or a cached "
                                 "{'ck', 'cv'}")
            if params["wq"].shape[-1] != self.n_heads * self.head_dim:
                # the replicated encoder states enter the column-parallel
                # K / V projections as the residual enters q's
                kv_src = copy_to(kv_src, ctx.mesh, "model")
            k, v = self._kv_proj(params, kv_src, policy, ctx)
            keep = self._share(ctx, k.shape[1])
            new_cache = {"ck": k, "cv": v} if keep is None else {
                "ck": k[:, keep[2]:keep[2] + keep[0]].contiguous(),
                "cv": v[:, keep[2]:keep[2] + keep[0]].contiguous()}
        B, S = q.shape[0], q.shape[1]
        T = k.shape[1]
        if mode == "decode" and S == 1 and self._use_kernel(ctx, q):
            T_all = T if share is None else share[1]
            index = torch.full((B,), T_all - 1, dtype=torch.int32, device=q.device)
            out = flash_decode(q, k, v, index, **self._decode_kw(ctx, share))
            return self._merge(out, ctx, q.dtype, share), new_cache
        mask = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=q.device)
        out = self._eager(q, k, v, mask, policy, share)
        return self._merge(out, ctx, v.dtype, share), new_cache


def _write_rows(k_all, v_all, rows, slot, k_tok, v_tok, share, keep=None):
    """k_all[rows, slot] = k_tok and v_all[rows, slot] = v_tok, in place, at
    a dense cache's slots: under a share the rank writes the slots its block
    holds (at slot - phase) and the others keep their bytes.  No two of the
    written (row, slot) may coincide."""
    if share is None:
        k_all[rows, slot] = k_tok
        v_all[rows, slot] = v_tok
        return
    sub, _, phase = share
    own = (slot >= phase) & (slot < phase + sub)
    if keep is not None:
        own = own & keep
    loc = torch.clamp(slot - phase, 0, sub - 1)
    for cache_t, tok in ((k_all, k_tok), (v_all, v_tok)):
        mask = own.reshape(own.shape + (1,) * (tok.dim() - own.dim()))
        cache_t[rows, loc] = torch.where(mask, tok, cache_t[rows, loc])


def _write_share(pool, page, off, new, share, keep=None, one_request=False):
    """`_write_slots` at page offsets of every rank's page (`off` < the
    whole page's size): under a share the rank writes the slots its pool
    holds (at off - phase), the others keep their bytes.  `one_request`'s
    tokens (a prefill's) are selected; a decode step's (B, S) tokens go one
    token a request at a time, so that no two writes of one scatter land on
    one slot (a request's pages are its own)."""
    if share is None:
        _write_slots(pool, page, off, new, keep=keep)
        return
    sub, _, phase = share
    own = (off >= phase) & (off < phase + sub)
    if keep is not None:
        own = own & keep
    loc = torch.clamp(off - phase, 0, sub - 1)
    if page.dim() == 2:
        for s in range(page.shape[1]):
            _write_slots(pool, page[:, s], loc[:, s], new[:, s], keep=own[:, s])
    elif one_request:  # a prefill's tokens: the rank's own, selected
        sel = torch.nonzero(own)[:, 0]
        _write_slots(pool, page[sel], loc[sel], new[sel])
    else:  # a token a request, each on its request's own pages
        _write_slots(pool, page, loc, new, keep=own)


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
