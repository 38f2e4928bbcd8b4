"""Plain PyTorch versions of the two attention kernels (GQA, causal /
sliding-window, softcap, caches).  They follow the *kernels*: fp32 math,
`p = exp(s - m) * mask` so a fully masked row yields 0 (not a uniform
average), output in q's dtype."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.decode import (
    decode_schedule,
    page_block_kv,
)
from repro_torch.kernels.flash_attention.kernel import MAX_BLOCK_KV, NEG_INF


def _masked_softmax_pv(scores: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor, pv_eq: str):
    """Unnormalised softmax(scores) . v and its denominator, as the kernels
    accumulate them: masked probabilities are exactly 0."""
    s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask.to(torch.float32)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum(pv_eq, p, v)
    return acc, l


def attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.to(torch.float32).reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(torch.float32)) \
        * (1.0 / math.sqrt(D))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
        if window is not None:  # the kernel windows only under the causal mask
            mask &= kp > qp - window
    acc, l = _masked_softmax_pv(scores, mask, v.to(torch.float32),
                                "bkgst,btkd->bkgsd")
    out = acc / torch.clamp(l, min=1e-30)  # (B, K, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def decode_ref(
    q: torch.Tensor,        # (B, S, H, D) — the S >= 1 new tokens
    k_cache: torch.Tensor,  # (B, T, K, D) cache with the new tokens written,
                            # or the (P, page_size, K, D) pool when paged
    v_cache: torch.Tensor,
    index: torch.Tensor,    # () or (B,) int: the first new token's position
    *,
    window: int | None = None,
    softcap: float | None = None,
    block_kv: int = MAX_BLOCK_KV,
    pruned: bool = True,
    tables: torch.Tensor | None = None,
    kv_len: int | None = None,
    k_scale: torch.Tensor | None = None,  # paged (P, K); dense (B, NP, K)
    v_scale: torch.Tensor | None = None,
    scale_page: int | None = None,        # dense only: slots per scale row
) -> torch.Tensor:
    """Touches only the cache blocks `decode_schedule` names for each
    request (through the block table when paged): whatever dead blocks or
    dead pages hold, NaNs included, cannot reach the output.

    With scales, each live K/V slot is dequantized as `float(code) * scale`
    in fp32 before it enters the products — the kernel's order, and the
    reference kernel's."""
    B, S, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    paged = tables is not None
    quant = k_scale is not None
    if quant and v_scale is None:
        raise ValueError("quantized decode requires both k/v scales")
    if paged:
        if kv_len is None:
            raise ValueError("paged decode requires kv_len")
        T = int(kv_len)
        page_size = k_cache.shape[1]
        bkv = page_block_kv(min(int(block_kv), MAX_BLOCK_KV), page_size)
    else:
        T = k_cache.shape[1]
        bkv = max(1, min(int(block_kv), MAX_BLOCK_KV, T))
        if quant:
            if scale_page is None:
                raise ValueError("dense quantized decode requires scale_page "
                                 "(cache slots per scale row)")
            bkv = page_block_kv(bkv, scale_page)  # one scale row per block
    idx = [int(i) for i in
           torch.as_tensor(index).reshape(-1).expand(B).tolist()]
    scale = 1.0 / math.sqrt(D)
    off = torch.arange(S, device=q.device)[:, None]  # token offset per q row
    outs = []
    for b in range(B):
        blocks = decode_schedule(T, idx[b], bkv, window=window, pruned=pruned,
                                 q_span=S)
        slots = torch.arange(blocks[0] * bkv, min((blocks[-1] + 1) * bkv, T),
                             device=q.device)
        if paged:
            page = tables[b].to(torch.long)[slots // page_size]
            kb = k_cache[page, slots % page_size]  # (n, K, D)
            vb = v_cache[page, slots % page_size]
            if quant:
                kb = kb.to(torch.float32) * k_scale[page][..., None]
                vb = vb.to(torch.float32) * v_scale[page][..., None]
        else:
            kb, vb = k_cache[b, slots], v_cache[b, slots]
            if quant:
                row = slots // scale_page
                kb = kb.to(torch.float32) * k_scale[b, row][..., None]
                vb = vb.to(torch.float32) * v_scale[b, row][..., None]
        qf = q[b].to(torch.float32).reshape(S, K, G, D)
        s = torch.einsum("skgd,tkd->kgst", qf, kb.to(torch.float32)) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        live = torch.clamp(idx[b] + off + 1, 1, T)  # (S, 1) per-row boundary
        mask = slots[None, :] < live
        if window is not None:  # linear cache under a sliding window
            mask = mask & (slots[None, :] > idx[b] + off - window)
        acc, l = _masked_softmax_pv(s, mask, vb.to(torch.float32),
                                    "kgst,tkd->kgsd")
        out = acc / torch.clamp(l, min=1e-30)  # (K, G, S, D)
        outs.append(out.permute(2, 0, 1, 3).reshape(S, H, D))
    return torch.stack(outs).to(q.dtype)
