"""Plain PyTorch versions of the attention kernels (GQA, causal /
sliding-window, softcap, caches) and of the fused backward.  They follow the
*kernels*: fp32 math, `p = exp(s - m) * mask` so a fully masked row yields 0
(not a uniform average), output in q's dtype; the backward recomputes P from
the forward's `lse` by the reference kernel's own formula."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.decode import (
    SPLIT_CHUNK,
    SPLIT_WARPS,
    decode_schedule,
    page_block_kv,
    split_decode_schedule,
    split_step_slots,
)
from repro_torch.kernels.flash_attention.kernel import (
    MAX_BLOCK_KV,
    NEG_INF,
    TC_BLOCK_KV,
    TC_BLOCK_Q,
)


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
    acc = _acc_dtype(q)
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
        qf = q[b].to(acc).reshape(S, K, G, D)
        s = torch.einsum("skgd,tkd->kgst", qf, kb.to(acc)) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        live = torch.clamp(idx[b] + off + 1, 1, T)  # (S, 1) per-row boundary
        mask = slots[None, :] < live
        if window is not None:  # linear cache under a sliding window
            mask = mask & (slots[None, :] > idx[b] + off - window)
        pv, l, _ = _masked_softmax_pv(s, mask, vb.to(acc), "kgst,tkd->kgsd")
        out = pv / torch.clamp(l, min=1e-30)  # (K, G, S, D)
        outs.append(out.permute(2, 0, 1, 3).reshape(S, H, D))
    return torch.stack(outs).to(q.dtype)


def _ordered_merge(parts):
    """Softmax partials (m, l, acc) merged in the order given, as the split
    route merges its warps and then its chunks: M = max m, each part
    weighted by exp(m - M) (M = 0 while every part has seen nothing)."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    Mu = torch.where(M == -math.inf, torch.zeros_like(M), M)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        e = torch.exp(m - Mu)
        L = L + l * e
        A = A + a * e
    return M, L, A


def decode_split_ref(
    q: torch.Tensor,        # (B, 1, H, D): one new token
    k_cache: torch.Tensor,  # (B, T, K, D) cache, or the (P, page_size, K, D) pool
    v_cache: torch.Tensor,
    index: torch.Tensor,    # () or (B,) int: the token's position
    *,
    window: int | None = None,
    softcap: float | None = None,
    pruned: bool = True,
    tables: torch.Tensor | None = None,
    kv_len: int | None = None,
    k_scale: torch.Tensor | None = None,  # paged (P, K); dense (B, NP, K)
    v_scale: torch.Tensor | None = None,
    scale_page: int | None = None,
    chunk: int = SPLIT_CHUNK,
) -> torch.Tensor:
    """The plain twin of flash decode's split route (one token): the same
    function as `decode_ref`, in the kernel's order of sums.  Each chunk of
    `split_decode_schedule` is cut into steps of `split_step_slots(D)` slots
    dealt to `SPLIT_WARPS` warps in turn; each warp's softmax partial over
    its live slots, (m, l, acc), is merged in warp order, and the chunks in
    chunk order (`_ordered_merge`), all in fp32 (float64 for float64
    inputs).  Codes enter the products as they are, with the scales
    factored out: score j times (its K scale x 1/sqrt(D)), p_j times its V
    scale in P V while l sums the unscaled p — where `decode_ref`
    dequantizes first, so the two agree up to fp32 rounding."""
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError("the split route takes one token")
    K = k_cache.shape[2]
    G = H // K
    paged = tables is not None
    quant = k_scale is not None
    if quant and v_scale is None:
        raise ValueError("quantized decode requires both k/v scales")
    if paged:
        if kv_len is None:
            raise ValueError("paged decode requires kv_len")
        T, page_size = int(kv_len), k_cache.shape[1]
    else:
        T = k_cache.shape[1]
        if quant and scale_page is None:
            raise ValueError("dense quantized decode requires scale_page")
    idx = [int(i) for i in torch.as_tensor(index).reshape(-1).expand(B).tolist()]
    acc = _acc_dtype(q)
    scale = 1.0 / math.sqrt(D)
    step = split_step_slots(D)
    outs = []
    for b in range(B):
        i = idx[b]
        row_lo = max(0, i - window + 1) if window is not None else 0
        row_hi = max(1, min(T, i + 1))
        qf = q[b, 0].to(acc).reshape(K, G, D)
        chunks = []
        for c, _ in split_decode_schedule(T, i, window=window, pruned=pruned, chunk=chunk):
            warps = []
            for w in range(SPLIT_WARPS):
                slots = torch.tensor(
                    [x for j in range(w, chunk // step, SPLIT_WARPS)
                     for x in range(c * chunk + j * step, c * chunk + (j + 1) * step)
                     if row_lo <= x < row_hi], dtype=torch.long, device=q.device)
                if slots.numel() == 0:  # a warp that saw nothing
                    warps.append((torch.full((K, G, 1), -math.inf, dtype=acc, device=q.device),
                                  torch.zeros((K, G, 1), dtype=acc, device=q.device),
                                  torch.zeros((K, G, D), dtype=acc, device=q.device)))
                    continue
                if paged:
                    page = tables[b].to(torch.long)[slots // page_size]
                    kb, vb = k_cache[page, slots % page_size], v_cache[page, slots % page_size]
                    if quant:
                        ks, vs = k_scale[page], v_scale[page]  # (n, K)
                else:
                    kb, vb = k_cache[b, slots], v_cache[b, slots]
                    if quant:
                        row = slots // scale_page
                        ks, vs = k_scale[b, row], v_scale[b, row]
                s = torch.einsum("kgd,tkd->kgt", qf, kb.to(acc))
                s = s * (ks.to(acc).T[:, None, :] * scale if quant else scale)
                if softcap is not None:
                    s = torch.tanh(s / softcap) * softcap
                m = torch.amax(s, dim=-1, keepdim=True)
                p = torch.exp(s - m)
                l = torch.sum(p, dim=-1, keepdim=True)
                pv = p * vs.to(acc).T[:, None, :] if quant else p
                warps.append((m, l, torch.einsum("kgt,tkd->kgd", pv, vb.to(acc))))
            chunks.append(_ordered_merge(warps))
        if chunks:
            _, L, A = _ordered_merge(chunks)
            out = A / torch.clamp(L, min=1e-30)
        else:
            out = torch.zeros((K, G, D), dtype=acc, device=q.device)
        outs.append(out.reshape(1, H, D))
    return torch.stack(outs).to(q.dtype)


def _bf16_parts(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """fp32 x as n bf16-exact parts that sum to it, as the tensor-core body
    splits P (`c_to_a_parts`): part j is the top 16 bits of what parts
    0..j-1 left of x, every subtraction exact."""
    parts = []
    for _ in range(n):
        top = (x.view(torch.int32) & -65536).view(torch.float32)  # 0xffff0000
        parts.append(top)
        x = x - top
    return parts


def decode_widened_codes_ref(
    q: torch.Tensor,        # (B, S, H, D) bf16: the S new tokens
    k_cache: torch.Tensor,  # (B, T, K, D) cache, or the (P, page_size, K, D) pool
    v_cache: torch.Tensor,  # of int8 / fp8 codes (or bf16 values)
    index: torch.Tensor,    # () or (B,) int: the first new token's position
    *,
    window: int | None = None,
    softcap: float | None = None,
    pruned: bool = True,
    tables: torch.Tensor | None = None,
    kv_len: int | None = None,
    k_scale: torch.Tensor | None = None,  # paged (P, K); dense (B, NP, K)
    v_scale: torch.Tensor | None = None,
    scale_page: int | None = None,        # dense only: slots per scale row
) -> torch.Tensor:
    """The plain twin of flash decode's tensor-core mode (S >= 1 bf16 tokens;
    its main use: widened q over a quantized cache): the same function as
    `decode_ref`, in the kernel's order of sums.  Each request's tokens go
    in blocks of `TC_BLOCK_Q` rows; a block walks the `TC_BLOCK_KV`-slot
    tiles from its first row's window to its last row's boundary with an
    online softmax (m = -inf while a row has seen nothing, p = exp(s - m)).
    Codes enter the products as they are, with the scales factored out:
    score j times (its K scale x 1/sqrt(D)), p_j times its V scale in P V
    while l sums the unscaled p; P enters P V as three bf16 parts, summed
    smallest first.  All fp32 (float64 inputs stay float64, P whole), so it
    agrees with `decode_ref` up to fp32 rounding.  A row's result depends on
    its own tiles only: the rows of a call at index P equal rows P.. of the
    whole prompt's call at index 0 when P is a multiple of `TC_BLOCK_Q`."""
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
        T, page_size = int(kv_len), k_cache.shape[1]
    else:
        T = k_cache.shape[1]
        if quant and scale_page is None:
            raise ValueError("dense quantized decode requires scale_page")
    idx = [int(i) for i in torch.as_tensor(index).reshape(-1).expand(B).tolist()]
    acc = _acc_dtype(q)
    scale = 1.0 / math.sqrt(D)
    BQ, BKV = TC_BLOCK_Q, TC_BLOCK_KV
    nk = -(-T // BKV)
    out = torch.zeros((B, S, H, D), dtype=acc, device=q.device)
    for b in range(B):
        i0 = idx[b]
        for q0 in range(0, S, BQ):
            n = min(BQ, S - q0)
            pos = i0 + q0 + torch.arange(n, device=q.device)[:, None]  # (n, 1)
            row_lo = pos - window + 1 if window is not None else torch.zeros_like(pos)
            row_hi = torch.clamp(pos + 1, 1, T)
            hi = -(-max(1, min(T, i0 + q0 + n)) // BKV)
            lo = 0
            if window is not None:
                lo = max(0, min((i0 + q0 + 1 - window) // BKV, hi - 1))
            qf = q[b, q0:q0 + n].to(acc).reshape(n, K, G, D)
            m = torch.full((K, G, n, 1), -math.inf, dtype=acc, device=q.device)
            l = torch.zeros((K, G, n, 1), dtype=acc, device=q.device)
            o = torch.zeros((K, G, n, D), dtype=acc, device=q.device)
            for jb in range(lo, hi) if pruned else range(nk):
                if not lo <= jb < hi:
                    continue  # streamed only (the unpruned baseline)
                slots = torch.arange(jb * BKV, min((jb + 1) * BKV, T), device=q.device)
                if paged:
                    page = tables[b].to(torch.long)[slots // page_size]
                    kb, vb = k_cache[page, slots % page_size], v_cache[page, slots % page_size]
                    if quant:
                        ks, vs = k_scale[page], v_scale[page]  # (t, K)
                else:
                    kb, vb = k_cache[b, slots], v_cache[b, slots]
                    if quant:
                        row = slots // scale_page
                        ks, vs = k_scale[b, row], v_scale[b, row]
                s_ = torch.einsum("skgd,tkd->kgst", qf, kb.to(acc))
                s_ = s_ * (ks.to(acc).T[:, None, None, :] * scale if quant else scale)
                if softcap is not None:
                    s_ = torch.tanh(s_ / softcap) * softcap
                live = (slots[None, :] >= row_lo) & (slots[None, :] < row_hi)  # (n, t)
                s_ = torch.where(live, s_, torch.full_like(s_, -math.inf))
                m_new = torch.maximum(m, torch.amax(s_, dim=-1, keepdim=True))
                m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
                alpha = torch.exp(m - m_use)
                p = torch.exp(s_ - m_use)
                l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
                m = m_new
                pv = p * vs.to(acc).T[:, None, None, :] if quant else p
                vf = vb.to(acc)
                if acc == torch.float32:
                    parts = _bf16_parts(pv, 3)
                    t = torch.einsum("kgst,tkd->kgsd", parts[2], vf)
                    t = t + torch.einsum("kgst,tkd->kgsd", parts[1], vf)
                    t = t + torch.einsum("kgst,tkd->kgsd", parts[0], vf)
                else:
                    t = torch.einsum("kgst,tkd->kgsd", pv, vf)
                o = o * alpha + t
            res = o / torch.clamp(l, min=1e-30)  # (K, G, n, D)
            out[b, q0:q0 + n] = res.permute(2, 0, 1, 3).reshape(n, H, D)
    return out.to(q.dtype)
