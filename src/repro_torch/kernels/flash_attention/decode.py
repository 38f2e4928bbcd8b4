"""Binding of the CUDA flash-decode kernel (`csrc/flash_decode.cu`) and the
schedule oracles of the decode walk.

The kernel replaces the reference's `flash_decode_fwd`: S >= 1 new q tokens
against a cache that already holds them, with a per-request `index`, linear
/ ring / windowed caches, widened q, paged pools, and int8 / fp8 caches with
fp32 per-page scales (the quantized mode).  The cache and q are read in the
model layout through strides; the block table and the scales are resolved
inside the kernel.  `decode_schedule` / `paged_decode_schedule` say which
blocks one step streams; they are framework-free copies of the reference's
oracles.

Each launch takes one of three routes (`decode_route`; the entry point
reports the one it launched, kept in `flash_decode_fwd.last_route`):

- "tc_split": one bf16 token over bf16 values or int8 / fp8 codes — every
  serving decode step.  The walk is cut into chunks of `SPLIT_CHUNK`
  logical slots (`split_decode_schedule`) that run as blocks of their own,
  the GQA group sits on the tensor cores, the scales are factored out of
  the products, and the chunks are combined in chunk order.  The chunk is
  fixed: a request's rows do not depend on the batch, the card or paging.
  Its plain twin is `ref.decode_split_ref`.
- "tc": S > 1 bf16 tokens over bf16 values or int8 / fp8 codes run K1's
  tensor-core body in 64-slot tiles: a suffix's rows equal K1's rows of the
  whole prompt bit for bit over values, and this route's own rows of the
  whole prompt at index 0 over codes (a quantized pool's first prefill
  takes this route too).  Over codes the tiles' codes are widened to bf16
  exactly and the scales are factored out of the products, as on the
  split route; its plain twin is `ref.decode_widened_codes_ref`.
- "fma": an fp32 q (over fp32 values or codes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import (
    MAX_BLOCK_KV,
    cdiv,
    check_qkv,
)

# the code types of a quantized cache the kernel reads (fp8 where torch has it)
QUANT_DTYPES = tuple(getattr(torch, n) for n in
                     ("int8", "float8_e4m3fn", "float8_e5m2") if hasattr(torch, n))

# The split route's walk: chunks of SPLIT_CHUNK logical slots (the compiled
# `kSplitChunk` of csrc/decode_split.cuh, which the entry point checks),
# made of SPLIT_TILE-slot schedule tiles; each chunk's block hands its steps
# to SPLIT_WARPS warps in turn.
SPLIT_CHUNK = 128
SPLIT_TILE = 64
SPLIT_WARPS = 4
SPLIT_ROWS = 16  # q rows of a block: the G heads of a KV head, one m16 tile


# ---------------------------------------------------------------------------
# Live-block interval + oracle
# ---------------------------------------------------------------------------


def _dec_hi(index: int, block_kv: int, T: int) -> int:
    """One past the last live KV block: the block holding min(T, index+1)-1."""
    return cdiv(max(1, min(T, index + 1)), block_kv)


def _dec_lo(index: int, block_kv: int, window: int | None, hi: int) -> int:
    """First live KV block (linear caches only: positions below the sliding
    window are dead).  Ring caches pass window=None — the ring layout holds
    only in-window positions by construction."""
    if window is None:
        return 0
    return min(max(0, (index + 1 - window) // block_kv), hi - 1)


def decode_steps_for(T: int, block_kv: int, window: int | None = None,
                     q_span: int = 1) -> int:
    """Max live KV blocks one decode step can stream, over all indices."""
    nk = cdiv(T, block_kv)
    if window is None:
        return nk
    span = window + q_span - 1
    return max(1, min(nk, cdiv(max(span - 1, 1), block_kv) + 1))


def decode_schedule(
    T: int, index: int, block_kv: int, *,
    window: int | None = None, pruned: bool = True, q_span: int = 1,
) -> list[int]:
    """KV blocks one decode step actually *streams* from a length-T cache:
    [lo, hi) when pruned, every block otherwise.  With `q_span` > 1 the
    interval covers the *last* stacked token (position index + q_span - 1)
    while lo stays anchored on the first."""
    nk = cdiv(T, block_kv)
    if not pruned:
        return list(range(nk))
    hi = _dec_hi(int(index) + q_span - 1, block_kv, T)
    lo = _dec_lo(int(index), block_kv, window, hi)
    return list(range(int(lo), int(hi)))


def page_block_kv(block_kv: int, page_size: int) -> int:
    """Clamp a streamed-block size so it tiles the page exactly: a block must
    never straddle a page boundary (adjacent logical pages are not adjacent in
    the pool), so the effective block is the largest common divisor."""
    return max(1, math.gcd(int(block_kv), int(page_size)))


def paged_decode_schedule(
    kv_len: int, index: int, block_kv: int, page_size: int, table,
    *, window: int | None = None, pruned: bool = True, q_span: int = 1,
) -> list[tuple[int, int]]:
    """Physical (page, sub_block) pairs one decode step streams from the
    pool — `decode_schedule` mapped through the request's block table."""
    bkv = page_block_kv(block_kv, page_size)
    spb = page_size // bkv
    logical = decode_schedule(kv_len, index, bkv, window=window, pruned=pruned,
                              q_span=q_span)
    return [(int(table[jb // spb]), jb % spb) for jb in logical]


def split_decode_schedule(
    T: int, index: int, *, window: int | None = None, pruned: bool = True,
    chunk: int = SPLIT_CHUNK,
) -> list[tuple[int, list[int]]]:
    """The chunks one single-token step of the split route walks, in the
    order they are combined: (chunk id, the `SPLIT_TILE`-slot tiles of
    `decode_schedule` it holds).  Chunk c holds tiles [c * chunk / 64,
    (c + 1) * chunk / 64) of the logical cache, so the partition depends
    on nothing but (T, index, window, pruned): not on the batch, the KV
    heads, the card or whether the cache is paged (a paged cache passes its
    `kv_len` as T)."""
    per = chunk // SPLIT_TILE
    out: list[tuple[int, list[int]]] = []
    for jb in decode_schedule(T, index, SPLIT_TILE, window=window, pruned=pruned):
        if not out or out[-1][0] != jb // per:
            out.append((jb // per, []))
        out[-1][1].append(jb)
    return out


def split_step_slots(D: int) -> int:
    """Slots of one warp's step on the split route at head dim D: 2048 / the
    padded head dim (64, 128, 256), at least one 16-slot k-slice of P V."""
    return max(16, 2048 // (64 if D <= 64 else 128 if D <= 128 else 256))


def decode_route(q_dtype, kv_dtype, S: int) -> str:
    """The route a CUDA launch takes (what the entry point reports)."""
    if q_dtype == torch.bfloat16 and (kv_dtype == torch.bfloat16 or kv_dtype in QUANT_DTYPES):
        return "tc_split" if S == 1 else "tc"
    return "fma"  # an fp32 q, over fp32 values or codes


_TICKETS: dict = {}  # device -> int32 counters of the split route, 0 between calls


def _split_tickets(device, n: int) -> torch.Tensor:
    """At least `n` of the split route's combine tickets on `device`, all 0:
    the block that combines a (request, KV head, row tile) resets its own,
    so the buffer is made once (and again only to grow).  Calls that share
    it run on one stream, one after another."""
    buf = _TICKETS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = buf
    return buf


# ---------------------------------------------------------------------------
# Entry point (model layout)
# ---------------------------------------------------------------------------


def flash_decode_fwd(
    q: torch.Tensor,      # (B, S, H, D): the S new tokens, read in place
    k: torch.Tensor,      # (B, T, K, D) cache — or (P, page_size, K, D) pool
    v: torch.Tensor,
    index: torch.Tensor,  # (B,) int32 on the card: first new token's position
    *,
    window: int | None = None,  # linear caches only; ring passes None
    softcap: float | None = None,
    block_kv: int = MAX_BLOCK_KV,
    pruned: bool = True,
    tables: torch.Tensor | None = None,  # (B, num_blocks) int32 page table
    kv_len: int | None = None,           # logical cache length (paged only)
    k_scale: torch.Tensor | None = None,  # fp32 scales: paged (P, K),
    v_scale: torch.Tensor | None = None,  # dense (B, NP, K)
    scale_page: int | None = None,        # dense only: slots per scale row
) -> torch.Tensor:
    code, kv_code = check_qkv(q, k, v, QUANT_DTYPES)
    B, S, H, D = q.shape
    K = k.shape[2]
    quant = kv_code >= 2
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 / fp8 caches need both k_scale and v_scale, and "
                         "value caches take none")
    if index.shape != (B,) or index.dtype != torch.int32 \
            or index.device != q.device or not index.is_contiguous():
        raise ValueError(f"index must be contiguous int32 ({B},) on {q.device}")
    block_kv = max(1, min(int(block_kv), MAX_BLOCK_KV))
    if tables is not None:
        if kv_len is None:
            raise ValueError("paged flash_decode requires kv_len")
        T = int(kv_len)
        page_size = k.shape[1]
        block_kv = page_block_kv(block_kv, page_size)
        if tables.dtype != torch.int32 or tables.device != q.device \
                or tables.ndim != 2 or not tables.is_contiguous():
            raise ValueError("tables must be contiguous int32 (B, num_blocks) "
                             f"on {q.device}")
        if tables.shape[0] != B or tables.shape[1] * page_size < T:
            raise ValueError(
                f"block table {tuple(tables.shape)} cannot cover kv_len={T} at "
                f"page_size={page_size} for batch {B}")
        nb = tables.shape[1]
        tables_ptr = tables.data_ptr()
    else:
        if k.shape[0] != B:
            raise ValueError("q and cache batch sizes differ")
        T = k.shape[1]
        page_size, nb, tables_ptr = 0, 0, None
        if quant:
            if scale_page is None:
                raise ValueError("dense quantized flash_decode requires "
                                 "scale_page (cache slots per scale row)")
            block_kv = page_block_kv(block_kv, scale_page)  # one row per block
    if T < 1:
        raise ValueError("decode against an empty cache")
    if B == 0 or S == 0:
        raise ValueError("empty q: there is nothing to launch")
    sc_ptrs, sc_strides = (None, None), (0, 0, 0)
    if quant:
        rows = k.shape[0] if tables is not None else -(-T // int(scale_page))
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            shape_ok = (tuple(sc.shape) == (rows, K) if tables is not None else
                        sc.ndim == 3 and sc.shape[0] == B and sc.shape[1] >= rows
                        and sc.shape[2] == K)
            if sc.dtype != torch.float32 or sc.device != q.device \
                    or not shape_ok or sc.stride() != k_scale.stride():
                raise ValueError(
                    f"{name} must be float32 on {q.device}, strided like "
                    f"k_scale: (pages, {K}) for a pool, ({B}, >= {rows}, {K}) "
                    f"for a dense cache; got {tuple(sc.shape)}")
        sc_ptrs = (k_scale.data_ptr(), v_scale.data_ptr())
        sc_strides = ((0, *k_scale.stride()) if tables is not None
                      else tuple(k_scale.stride()))
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    part = tickets = None
    if decode_route(q.dtype, k.dtype, S) == "tc_split":
        # fp32 (acc, m, l) of every (request, head, chunk), and the tickets
        part = torch.empty(B * H * cdiv(T, SPLIT_CHUNK) * (D + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _split_tickets(q.device, B * K * cdiv(H // K, SPLIT_ROWS))
    route = build.route_out()
    err = build.library().repro_torch_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        index.data_ptr(), tables_ptr, *sc_ptrs, code, kv_code,
        B, S, T, H, K, D, nb, page_size,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        *sc_strides, int(scale_page or 0),
        int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(D), block_kv, int(bool(pruned)),
        part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, SPLIT_CHUNK,
        ctypes.byref(route),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "flash_decode")
    flash_decode_fwd.last_route = build.route_name(route)
    return out


flash_decode_fwd.last_route = None  # the mode the last launch reported
