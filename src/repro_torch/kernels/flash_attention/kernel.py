"""Bindings of the CUDA flash-attention forward (`csrc/flash_prefill.cu`) and
fused backward (`csrc/flash_bwd.cu`), the choice of route and tiles both
make, and the numpy-free schedule oracles of their walks.

The kernels replace the reference's `flash_attention_fwd` and
`flash_attention_bwd`.  They read every operand in the model layout through
strides and mask ragged edges themselves, so the wrappers make no transposed
or padded copies.  The type pair picks the route before any launch
(`attention_route`): bf16 q, k, v take the tensor-core route (mma.sync on
bf16 tiles, tiles compiled in: `TC_BLOCK_*`), everything
else — fp32, and a bf16 q over the fp32 K / V of a dequantized page pool —
the fp32 FMA route, whose blocks are the requested ones up to its
`MAX_BLOCK_*` capacity.  `kv_schedule` (the forward / dq walk) and
`q_schedule` (the transposed dk / dv walk) say which blocks a configuration
streams; they are framework-free copies of the reference's oracles (same
results on every input) and feed both the tests and the bound computed for a
measurement.  `dkv_split_schedule` is the dk / dv walk of the tensor-core
route once its GQA group is split across `dkv_n_split` blocks.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# The FMA route (fp32, and bf16 q over fp32 K / V): capacity of its
# shared-memory tiles (csrc/attend_core.cuh, csrc/flash_prefill.cu); larger
# requested blocks are clamped to it.  MAX_BLOCK_KV is also the decode
# kernel's (K2) block capacity.
MAX_BLOCK_Q = 64
MAX_BLOCK_KV = 64
MAX_HEAD_DIM = 256
# ... and of the FMA backward's (csrc/flash_bwd.cu: 64 q rows, 32 KV rows in
# both passes — 202 / 210 KB of shared memory at head_dim 256)
MAX_BLOCK_Q_BWD = 64
MAX_BLOCK_KV_BWD = 32

# The tensor-core route (bf16 q, k, v): tiles compiled into the kernels.
# Forward: 64 q rows per block (4 warps; 160 KB of shared memory at head_dim
# 256), 64-row K / V tiles.  Backward: 64 q rows per dq block and per dk / dv
# q tile, 64 KV rows per dk / dv block and per dq K / V tile.  Head dims are
# padded to the next instantiated one.
TC_BLOCK_Q = 64
TC_BLOCK_KV = 64
TC_BLOCK_Q_BWD = 64
TC_BLOCK_KV_BWD = 64
# the dk / dv pass splits a KV head's group until the grid has this many
# blocks per streaming multiprocessor (or the group runs out)
TC_DKV_BLOCKS_PER_SM = 2


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Reachable KV-block interval per q block
# ---------------------------------------------------------------------------


def _kv_lo(iq: int, block_q: int, block_kv: int, window: int | None) -> int:
    """First reachable KV block for q block `iq` (lowest kp = q_start-window+1)."""
    if window is None:
        return 0
    return max(0, (iq * block_q - (window - 1)) // block_kv)


def _kv_hi(iq: int, block_q: int, block_kv: int, nk: int) -> int:
    """One past the last reachable KV block (highest kp = q_start+block_q-1)."""
    return min(nk, (iq * block_q + block_q - 1) // block_kv + 1)


def _interval_steps(n_outer: int, lo_fn, hi_fn) -> int:
    """Max interval length over outer blocks."""
    steps = 0
    for i in range(n_outer):
        steps = max(steps, hi_fn(i) - lo_fn(i))
    return max(steps, 1)


def _interval_schedule(n_outer: int, steps: int, lo_fn, hi_fn) -> list[list[int]]:
    """Step j of outer block i visits min(lo+j, hi-1); a repeated index
    streams nothing, so overshoot steps are dropped from the row."""
    out: list[list[int]] = []
    for i in range(n_outer):
        lo, hi = lo_fn(i), hi_fn(i)
        row: list[int] = []
        for j in range(steps):
            idx = min(lo + j, max(hi - 1, lo))
            if not row or row[-1] != idx:
                row.append(idx)
        out.append(row)
    return out


def kv_steps_for(
    S: int, T: int, block_q: int, block_kv: int,
    causal: bool, window: int | None,
) -> int:
    """Max reachable KV blocks over all q blocks."""
    nq, nk = cdiv(S, block_q), cdiv(T, block_kv)
    if not causal:
        return nk
    return _interval_steps(
        nq,
        lambda iq: _kv_lo(iq, block_q, block_kv, window),
        lambda iq: _kv_hi(iq, block_q, block_kv, nk),
    )


def block_fully_masked(
    iq: int, ik: int, block_q: int, block_kv: int, *,
    kv_len: int, causal: bool, window: int | None,
) -> bool:
    """True iff no (q, k) pair inside block (iq, ik) survives the mask."""
    q0, q1 = iq * block_q, iq * block_q + block_q - 1
    k0 = ik * block_kv
    k1 = min(ik * block_kv + block_kv - 1, kv_len - 1)
    if k0 >= kv_len:
        return True
    if not causal:
        return False
    if k0 > q1:  # entirely above the diagonal
        return True
    if window is not None and k1 <= q0 - window:  # entirely out of window
        return True
    return False


def kv_schedule(
    S: int, T: int, block_q: int, block_kv: int, *,
    causal: bool = True, window: int | None = None, pruned: bool = True,
) -> list[list[int]]:
    """Per-q-block list of KV block indices actually *streamed*: the pruned
    walk covers [kv_lo(iq), kv_hi(iq)), the dense walk every KV block."""
    nq, nk = cdiv(S, block_q), cdiv(T, block_kv)
    if not (causal and pruned):
        return [list(range(nk)) for _ in range(nq)]
    return _interval_schedule(
        nq,
        kv_steps_for(S, T, block_q, block_kv, causal, window),
        lambda iq: _kv_lo(iq, block_q, block_kv, window),
        lambda iq: _kv_hi(iq, block_q, block_kv, nk),
    )


# ---------------------------------------------------------------------------
# Reachable Q-block interval per KV block (the transposed schedule of the
# dk / dv backward pass)
# ---------------------------------------------------------------------------


def _q_lo(ik: int, block_q: int, block_kv: int, nq: int) -> int:
    """First reachable Q block for kv block `ik` (the block containing k0 —
    causal reach starts at qp >= k0)."""
    return min((ik * block_kv) // block_q, nq - 1)


def _q_hi(ik: int, block_q: int, block_kv: int, nq: int, kv_len: int,
          window: int | None) -> int:
    """One past the last reachable Q block (highest qp = k1 + window - 1 for
    windowed attention, else every later q block)."""
    if window is None:
        return nq
    k1 = min((ik + 1) * block_kv, kv_len) - 1
    return max(1, min(nq, (k1 + window - 1) // block_q + 1))


def q_steps_for(
    S: int, T: int, block_q: int, block_kv: int,
    causal: bool, window: int | None,
) -> int:
    """Max reachable Q blocks over all kv blocks."""
    nq, nk = cdiv(S, block_q), cdiv(T, block_kv)
    if not causal:
        return nq
    return _interval_steps(
        nk,
        lambda ik: _q_lo(ik, block_q, block_kv, nq),
        lambda ik: _q_hi(ik, block_q, block_kv, nq, T, window),
    )


def q_schedule(
    S: int, T: int, block_q: int, block_kv: int, *,
    causal: bool = True, window: int | None = None, pruned: bool = True,
) -> list[list[int]]:
    """Per-KV-block list of Q block indices the dk / dv pass *streams* — the
    exact transpose of `kv_schedule`: the pruned walk covers
    [q_lo(ik), q_hi(ik)), the dense walk every q block."""
    nq, nk = cdiv(S, block_q), cdiv(T, block_kv)
    if not (causal and pruned):
        return [list(range(nq)) for _ in range(nk)]
    return _interval_schedule(
        nk,
        q_steps_for(S, T, block_q, block_kv, causal, window),
        lambda ik: _q_lo(ik, block_q, block_kv, nq),
        lambda ik: _q_hi(ik, block_q, block_kv, nq, T, window),
    )


# ---------------------------------------------------------------------------
# Routes and tiles
# ---------------------------------------------------------------------------


def attention_route(q_dtype, kv_dtype) -> str:
    """"tc" (tensor cores) for bf16 q over bf16 K / V, else "fma"."""
    return "tc" if q_dtype == kv_dtype == torch.bfloat16 else "fma"


def route_blocks(route: str, block_q: int, block_kv: int, *,
                 backward: bool = False) -> tuple[int, int]:
    """The tiles a launch runs with.  The FMA route takes the requested
    blocks, clamped to its capacity; the tensor-core route's tiles are
    compiled in, so any request (a woven `flash_block_*`, the tuner's) maps
    to them — they change which blocks are streamed, never the result."""
    if route == "tc":
        return (TC_BLOCK_Q_BWD, TC_BLOCK_KV_BWD) if backward else (TC_BLOCK_Q, TC_BLOCK_KV)
    cap_q, cap_kv = ((MAX_BLOCK_Q_BWD, MAX_BLOCK_KV_BWD) if backward
                     else (MAX_BLOCK_Q, MAX_BLOCK_KV))
    return max(1, min(int(block_q), cap_q)), max(1, min(int(block_kv), cap_kv))


def dkv_n_split(B: int, K: int, T: int, G: int, sms: int) -> int:
    """Blocks per (KV block, KV head) of the tensor-core dk / dv pass: the
    smallest divisor of the group G that gives the grid at least
    `TC_DKV_BLOCKS_PER_SM * sms` blocks, else G."""
    blocks = B * K * cdiv(T, TC_BLOCK_KV_BWD)
    for n in range(1, G + 1):
        if G % n == 0 and blocks * n >= TC_DKV_BLOCKS_PER_SM * sms:
            return n
    return G


def dkv_split_schedule(
    S: int, T: int, G: int, n_split: int, block_q: int, block_kv: int, *,
    causal: bool = True, window: int | None = None, pruned: bool = True,
) -> list[list[list[tuple[int, int]]]]:
    """Per KV block, per split: the (q head in the group, q block) pairs the
    tensor-core dk / dv pass streams, in its walk order — split s takes the
    heads [s G / n_split, (s + 1) G / n_split) over the KV block's q-block
    interval [q_lo, q_hi) (every q block without pruning), from its last q
    block back to its first, all the split's heads at each — computed with
    the kernel's own arithmetic (csrc/flash_bwd.cu)."""
    if n_split < 1 or G % n_split:
        raise ValueError(f"n_split {n_split} must divide the group {G}")
    nq, nk = cdiv(S, block_q), cdiv(T, block_kv)
    per = G // n_split
    out = []
    for ik in range(nk):
        lo, hi = 0, nq
        if causal and pruned:
            lo = _q_lo(ik, block_q, block_kv, nq)
            hi = _q_hi(ik, block_q, block_kv, nq, T, window)
        out.append([[(g, iq) for iq in reversed(range(lo, hi))
                     for g in range(s * per, (s + 1) * per)] for s in range(n_split)])
    return out


# ---------------------------------------------------------------------------
# Entry points (model layout)
# ---------------------------------------------------------------------------


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_types=()) -> tuple[int, int]:
    """Shared operand checks of both attention kernels; returns the dtype
    codes of q and of k / v.  K and V share one type: q's own, or one of
    `kv_types` (fp32 values under a bf16 q, the codes of a quantized cache)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if k.dtype != v.dtype or (k.dtype != q.dtype and k.dtype not in kv_types):
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: k and v "
                        f"must share q's type or one of {list(kv_types)}")
    code, kv_code = build.dtype_code(q.dtype), build.kv_dtype_code(k.dtype)
    if not (q.ndim == k.ndim == v.ndim == 4) or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    D = q.shape[-1]
    if k.shape[-1] != D or D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} must be a multiple of 8, at most "
                         f"{MAX_HEAD_DIM}, and equal for q and k/v")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    build.check_operand("q", q, 16 // q.element_size())
    kv_vec = 8 if k.element_size() == 1 else 16 // k.element_size()
    for name, t in (("k", k), ("v", v)):
        build.check_operand(name, t, kv_vec)
    return code, kv_code


def flash_attention_fwd(
    q: torch.Tensor,  # (B, S, H, D) — the model layout, read in place
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = MAX_BLOCK_Q,
    block_kv: int = MAX_BLOCK_KV,
    pruned: bool = True,
    return_lse: bool = False,
):
    """Returns the output (B, S, H, D) in q's type; with `return_lse` also the
    per-row softmax statistics `lse = m + log(l)` as (B, H, S) fp32 — the
    residual the fused backward recomputes probabilities from."""
    # fp32 K/V under a bf16 q: the dequantized values of a quantized pool
    kv_types = (torch.float32,) if q.dtype == torch.bfloat16 else ()
    code, kv_code = check_qkv(q, k, v, kv_types)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError("q and k/v batch sizes differ")
    block_q, block_kv = route_blocks(attention_route(q.dtype, k.dtype), block_q,
                                     block_kv)
    if B == 0 or S == 0:
        raise ValueError("empty q: there is nothing to launch")
    if T < 1:
        raise ValueError("attention over an empty key sequence")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    route = build.route_out()
    err = build.library().repro_torch_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, code, kv_code,
        B, S, T, H, K, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(D), block_q, block_kv, int(bool(pruned)), ctypes.byref(route),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "flash_attention")
    flash_attention_fwd.last_route = build.route_name(route)
    return (out, lse) if return_lse else out


flash_attention_fwd.last_route = None  # the route the last launch reported


def flash_attention_bwd(
    q: torch.Tensor,    # (B, S, H, D) — model layout, read in place
    k: torch.Tensor,    # (B, T, K, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, S) fp32 the forward's softmax statistics
    do: torch.Tensor,   # (B, S, H, D) the output's cotangent
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = MAX_BLOCK_Q_BWD,
    block_kv: int = MAX_BLOCK_KV_BWD,
    pruned: bool = True,
    passes: int = 3,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward: (dq, dk, dv) in the model layout, dq in q's type,
    dk / dv (B, T, K, D) in k's type — group-summed over the G q heads of
    each KV head inside the kernel, never an (..., H, ...) transient.  The
    kernel keeps the dk / dv sums in fp32 on chip and writes each element
    once, rounded once to k's type: the values the reference's fp32
    (B, K, T, D) output and its cast give, without the fp32 round trip
    through device memory.  `delta = rowsum(dO * O)` is fused into the dq
    pass.  K / V must share q's type (the quantized pool's fp32 K / V under
    a bf16 q is a serving case; nothing differentiates through it).

    `passes` 3 (the default, the training path) launches both passes; 1
    (dq, writing `delta`) or 2 (dk / dv, reading the `delta` an earlier
    pass 1 wrote) launches one alone, so that each can be timed — the
    outputs of the pass not launched are left unwritten.

    On the tensor-core route (bf16) the dk / dv pass splits each KV head's
    group across `dkv_n_split` blocks for the device: with more than one,
    the blocks write fp32 partial sums to a scratch tensor that a third
    launch, part of pass 2, adds in split order."""
    code, _ = check_qkv(q, k, v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError("q and k/v batch sizes differ")
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} vs "
                             f"{q.dtype} {tuple(q.shape)}")
        build.check_operand(name, t, 16 // t.element_size())
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 of shape {(B, H, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if B == 0 or S == 0 or T == 0:
        raise ValueError("empty q or k: there is nothing to launch")
    route = attention_route(q.dtype, k.dtype)
    block_q, block_kv = route_blocks(route, block_q, block_kv, backward=True)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, not {passes}")
    if delta is None:
        if passes == 2:
            raise ValueError("the dk / dv pass alone reads the delta of an "
                             "earlier dq pass: pass `delta`")
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    elif (delta.shape != (B, H, S) or delta.dtype != torch.float32
          or delta.device != q.device or not delta.is_contiguous()):
        raise ValueError(f"delta must be contiguous float32 of shape {(B, H, S)}")
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, T, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, K, D), dtype=k.dtype, device=q.device)
    n_split = 1 if route != "tc" else dkv_n_split(
        B, K, T, H // K, torch.cuda.get_device_properties(q.device).multi_processor_count)
    partial = (torch.empty((2, n_split, B, T, K, D), dtype=torch.float32,
                           device=q.device) if n_split > 1 and passes & 2 else None)
    reported = build.route_out()
    err = build.library().repro_torch_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), partial.data_ptr() if partial is not None else None,
        code, B, S, T, H, K, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        dq.stride(0), dq.stride(1), dq.stride(2),
        dk.stride(0), dk.stride(1), dk.stride(2),
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(D), block_q, block_kv, int(bool(pruned)), int(n_split),
        int(passes), ctypes.byref(reported), torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "flash_attention_bwd")
    flash_attention_bwd.last_route = build.route_name(reported)
    return dq, dk, dv


flash_attention_bwd.last_route = None  # the route the last launch reported
