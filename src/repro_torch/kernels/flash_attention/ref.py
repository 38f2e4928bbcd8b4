"""Plain PyTorch versions of the attention kernels (GQA, causal /
sliding-window, softcap, caches) and of the fused backward.  They follow the
*kernels*: fp32 math, `p = exp(s - m) * mask` so a fully masked row yields 0
(not a uniform average), output in q's dtype; the backward recomputes P from
the forward's `lse` by the reference kernel's own formula."""

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
    """Unnormalised softmax(scores) . v, its denominator and its running
    max, as the kernels accumulate them: masked probabilities are exactly 0."""
    s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask.to(s.dtype)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum(pv_eq, p, v)
    return acc, l, m


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """The kernels' fp32; float64 inputs (a gradient check) stay float64."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores_and_mask(q, k, *, causal, window, softcap):
    """fp32 (B, K, G, S, T) scores (softcapped) and the (S, T) mask of the
    kernels: the window applies only under the causal mask."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(B, S, K, H // K, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(acc)) \
        * (1.0 / math.sqrt(D))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
    return scores, mask


def attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    return_lse: bool = False,
):
    """The output (B, S, H, D) in q's type; with `return_lse` also the
    kernel's per-row statistics `lse = m + log(max(l, 1e-30))`, (B, H, S)
    fp32.  A fully masked row keeps output 0 and lse ~ -1e30, so the
    backward's exp(s_masked - lse) stays finite and the mask zeroes it."""
    B, S, H, D = q.shape
    scores, mask = _scores_and_mask(q, k, causal=causal, window=window,
                                    softcap=softcap)
    acc, l, m = _masked_softmax_pv(scores, mask, v.to(scores.dtype),
                                   "bkgst,btkd->bkgsd")
    denom = torch.clamp(l, min=1e-30)
    out = acc / denom  # (B, K, G, S, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(denom))[..., 0].reshape(B, H, S)
    return out, lse


def flash_attention_bwd_ref(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, T, K, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, S) fp32 the forward's softmax statistics
    do: torch.Tensor,   # (B, S, H, D) the output's cotangent
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the residuals by the reference kernel's formula
    (`_bwd_p_ds`): delta = rowsum(dO * O), P = exp(s_masked - lse) * mask,
    dS = P * (dP - delta) [* (1 - (s/c)^2) under a softcap c], dq = dS K *
    scale, dk = dS^T Q * scale, dv = P^T dO — all fp32, dq in q's type, dk /
    dv group-summed to the K KV heads in k's type.  It never differentiates
    through `attention_ref`."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    acc = _acc_dtype(q)
    s, mask = _scores_and_mask(q, k, causal=causal, window=window,
                               softcap=softcap)
    lse5 = lse.to(acc).reshape(B, K, G, S)[..., None]
    p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF)) - lse5) \
        * mask.to(acc)
    dof = do.to(acc).reshape(B, S, K, G, D)
    delta = torch.sum(dof * out.to(acc).reshape(B, S, K, G, D), dim=-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.to(acc))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(s / softcap))
    qf = q.to(acc).reshape(B, S, K, G, D)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


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
        acc, l, _ = _masked_softmax_pv(s, mask, vb.to(torch.float32),
                                       "kgst,tkd->kgsd")
        out = acc / torch.clamp(l, min=1e-30)  # (K, G, S, D)
        outs.append(out.permute(2, 0, 1, 3).reshape(S, H, D))
    return torch.stack(outs).to(q.dtype)
