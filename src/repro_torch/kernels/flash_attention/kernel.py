"""Binding of the CUDA flash-attention forward (`csrc/flash_prefill.cu`) and
the numpy-free schedule oracles of the prefill walk.

The kernel replaces the reference's `flash_attention_fwd`.  It reads q / k /
v in the model layout through strides and masks ragged edges itself, so the
wrapper makes no transposed or padded copies.  `kv_schedule` and friends say
which KV blocks a configuration streams; they are framework-free copies of
the reference's oracles (same results on every input) and feed both the
tests and the bound computed for a measurement.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# capacity of the kernel's shared-memory tiles (csrc/attend_core.cuh,
# csrc/flash_prefill.cu): larger requested blocks are clamped to it
MAX_BLOCK_Q = 64
MAX_BLOCK_KV = 64
MAX_HEAD_DIM = 256


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
# Entry point (model layout)
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
) -> torch.Tensor:
    # fp32 K/V under a bf16 q: the dequantized values of a quantized pool
    kv_types = (torch.float32,) if q.dtype == torch.bfloat16 else ()
    code, kv_code = check_qkv(q, k, v, kv_types)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError("q and k/v batch sizes differ")
    block_q = max(1, min(int(block_q), MAX_BLOCK_Q))
    block_kv = max(1, min(int(block_kv), MAX_BLOCK_KV))
    if B == 0 or S == 0:
        raise ValueError("empty q: there is nothing to launch")
    if T < 1:
        raise ValueError("attention over an empty key sequence")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = build.library().repro_torch_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, kv_code,
        B, S, T, H, K, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(bool(causal)), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        1.0 / math.sqrt(D), block_q, block_kv, int(bool(pruned)),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "flash_attention")
    return out
