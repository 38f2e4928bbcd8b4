"""Public wrappers for the flash-attention kernels.

They take model-layout tensors, (B, S, H, D) / (B, T, K, D), and hand them
to the kernels as they are (the kernels address them through strides).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises — there is no fallback from one to the other.  Each wrapper counts
its kernel launches in a plain integer `launches` attribute.

`flash_attention` is differentiable: when autograd needs the gradient of q,
k or v it runs `_FlashCore`, the counterpart of the reference's
`_flash_core` custom VJP — the forward keeps its softmax statistics (`lse`)
and the backward is the fused two-pass kernel (`flash_attention_bwd`), never
a recomputation through the plain attention.  Without a gradient to take it
runs the forward alone, without `lse`, as serving always did.

Block sizes left unspecified (None) take the kernel's tile capacity; woven
`flash_block_*` extras override and are clamped to that capacity.  Backward
blocks left unspecified take the forward's, as the reference's
`_resolve_blocks` does (then clamped to the backward's capacity).

The quantization primitives of the int8 / fp8 page pool live here too, as in
the reference: a page stores narrow codes beside one fp32 scale per KV head,
and a value is `float(code) * scale`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
from repro_torch.kernels.flash_attention.kernel import (
    MAX_BLOCK_KV,
    MAX_BLOCK_Q,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd as _flash_attention_bwd_kernel,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    decode_ref,
    flash_attention_bwd_ref,
)

DEFAULT_BLOCK_Q = MAX_BLOCK_Q
DEFAULT_BLOCK_KV = MAX_BLOCK_KV
DEFAULT_BLOCK_KV_DEC = MAX_BLOCK_KV
DEFAULT_PAGE_SIZE = 128

# Quantized KV-cache dtypes: name -> largest representable magnitude.  The
# per-page-per-head scale is abs_max / qmax, so dequant is value * scale.
# fp8 entries appear only when the installed torch ships the dtype.
CACHE_QMAX: dict[str, float] = {"int8": 127.0}
if hasattr(torch, "float8_e4m3fn"):
    CACHE_QMAX["float8_e4m3fn"] = 448.0
if hasattr(torch, "float8_e5m2"):
    CACHE_QMAX["float8_e5m2"] = 57344.0


def cache_qmax(dtype) -> float:
    """qmax for a quantized-cache dtype (accepts names and torch dtypes)."""
    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    return CACHE_QMAX[name]


def resolve_cache_dtype(name):
    """Map a `cache_dtype` knob value to a torch storage dtype, or None when
    the value names no quantized format (fp values mean: keep the fp pool)."""
    if name is None:
        return None
    name = str(name)
    if name not in CACHE_QMAX:
        return None
    return {"int8": torch.int8,
            "float8_e4m3fn": getattr(torch, "float8_e4m3fn", None),
            "float8_e5m2": getattr(torch, "float8_e5m2", None)}[name]


def kv_scale_from_absmax(absmax, dtype):
    """Per-page scale from a page's abs-max: absmax / qmax, so the stored
    code range spans the full [-qmax, qmax] grid.  Keeps the 0.0 free-page
    sentinel: zero absmax stays zero."""
    return absmax / cache_qmax(dtype)


def quantize_kv_write(x, scale, dtype):
    """Quantize K/V values at *fixed* per-page scales: x (..., K, D) against
    scale (..., K).  Values louder than the page's recorded abs-max clip —
    scales are never recomputed on already-written slots, which keeps CoW
    sharing bit-deterministic.  Integer codes round half to even, as
    `jnp.round` does; the fp8 casts round to nearest even."""
    qmax = cache_qmax(dtype)
    s = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    y = torch.clamp(x.to(torch.float32) / s, -qmax, qmax)
    if not dtype.is_floating_point:
        y = torch.round(y)
    return y.to(dtype)


def dequantize_kv(x, scale):
    """fp32 dequant of (..., K, D) quantized values at (..., K) scales."""
    return x.to(torch.float32) * scale.to(torch.float32)[..., None]


def _forward(q, k, v, *, causal, window, softcap, block_q, block_kv, pruned,
             return_lse):
    """One forward: the plain version for a CPU tensor, else one K1 launch
    (counted; with `return_lse` also in `flash_attention.lse_launches`)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, return_lse=return_lse)
    res = flash_attention_fwd(  # launches or raises
        q, k, v, causal=causal, window=window, softcap=softcap,
        block_q=block_q, block_kv=block_kv, pruned=pruned,
        return_lse=return_lse)
    flash_attention.launches += 1
    if return_lse:
        flash_attention.lse_launches += 1
    return res


class _FlashCore(torch.autograd.Function):
    """Attention with the fused backward.  The forward saves (q, k, v, out,
    lse) — all the two-pass recipe needs to recompute probability tiles —
    and the backward runs `flash_attention_bwd` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_kv,
                block_q_bwd, block_kv_bwd, pruned):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            softcap=softcap, block_q=block_q,
                            block_kv=block_kv, pruned=pruned, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        block_q=block_q_bwd, block_kv=block_kv_bwd,
                        pruned=pruned)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         **ctx.opts)
        return (dq, dk, dv) + (None,) * 8


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int | None = None,
    block_kv: int | None = None,
    block_q_bwd: int | None = None,
    block_kv_bwd: int | None = None,
    pruned: bool = True,
) -> torch.Tensor:
    block_q = DEFAULT_BLOCK_Q if block_q is None else int(block_q)
    block_kv = DEFAULT_BLOCK_KV if block_kv is None else int(block_kv)
    block_q_bwd = block_q if block_q_bwd is None else int(block_q_bwd)
    block_kv_bwd = block_kv if block_kv_bwd is None else int(block_kv_bwd)
    if q.device.type != "cpu" and q.numel() == 0:
        return torch.empty_like(q)  # nothing to launch, nothing counted
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashCore.apply(q, k, v, causal, window, softcap, block_q,
                                block_kv, block_q_bwd, block_kv_bwd, pruned)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    block_q=block_q, block_kv=block_kv, pruned=pruned,
                    return_lse=False)


flash_attention.launches = 0  # K1 launches made through this wrapper
flash_attention.lse_launches = 0  # of which in the training mode (with lse)


def flash_attention_bwd(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, T, K, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, H, S) fp32 its softmax statistics
    do: torch.Tensor,   # (B, S, H, D) the output's cotangent
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int | None = None,
    block_kv: int | None = None,
    pruned: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the model layout; dk / dv have the K KV heads.  A CPU
    tensor takes the plain version; a CUDA tensor launches the two-pass
    kernel (one call, counted once in `launches`: a dq pass and a dk / dv
    pass) or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    res = _flash_attention_bwd_kernel(  # launches or raises
        q, k, v, out, lse, do, causal=causal, window=window, softcap=softcap,
        block_q=DEFAULT_BLOCK_Q if block_q is None else block_q,
        block_kv=DEFAULT_BLOCK_KV if block_kv is None else block_kv,
        pruned=pruned)
    flash_attention_bwd.launches += 1
    return res


flash_attention_bwd.launches = 0  # K3 calls (each a dq and a dk / dv launch)


def paged_gather_kv(pk, pv, tables, kv_len: int, k_scale=None, v_scale=None):
    """Materialize the logical (B, kv_len, K, D) K/V view of a page pool
    through per-request block tables — the plain twin of the indirection the
    paged `flash_decode` kernel performs.  Shared (prefix-cached) pages gather
    exactly like exclusive ones: the table row is the only addressing.

    With `k_scale`/`v_scale` ((P, K) fp32 sidecars of a quantized pool) the
    gathered view is dequantized to fp32, as the kernel does per block."""
    B, nb = tables.shape
    ps = pk.shape[-3]  # pool layout (P, page_size, K, D)
    tables = tables.to(torch.long)
    k = pk[tables]  # (B, nb, page_size, K, D)
    v = pv[tables]
    if k_scale is not None:
        k = k.to(torch.float32) * k_scale[tables][:, :, None, :, None]
        v = v.to(torch.float32) * v_scale[tables][:, :, None, :, None]
    k = k.reshape(B, nb * ps, *pk.shape[-2:])[:, :kv_len]
    v = v.reshape(B, nb * ps, *pv.shape[-2:])[:, :kv_len]
    return k, v


# ---------------------------------------------------------------------------
# Decode (a small block of new tokens against a cache) — the serving hot path
# ---------------------------------------------------------------------------


def _fold_decode_q(q, K):
    """Model layout (B, S, H, D) -> the kernels' row order (B, K, S*G, D).

    Heads h = kh*G + g fold into the (K, G) block/row split of the decode
    kernel; with S > 1 the S tokens stack token-major so row r = token
    r // G.  The CUDA kernel computes this addressing itself; the function
    documents it and lets tests build the folded view."""
    B, S, H, D = q.shape
    G = H // K
    qt = q.reshape(B, S, K, G, D)
    qt = qt.movedim(2, 1)  # (B, K, S, G, D)
    return qt.reshape(B, K, S * G, D)


def _unfold_decode_o(out, B, S, H, D, K):
    """Inverse of `_fold_decode_q`: (B, K, S*G, D) -> (B, S, H, D)."""
    G = H // K
    o = out.reshape(B, K, S, G, D)
    o = o.movedim(1, 2)  # (B, S, K, G, D)
    return o.reshape(B, S, H, D)


def flash_decode(
    q: torch.Tensor,        # (B, S, H, D) — the S >= 1 new tokens, post-RoPE
    k_cache: torch.Tensor,  # (B, T, K, D) cache *with the new tokens written*,
                            # or the (P, page_size, K, D) page pool when paged
    v_cache: torch.Tensor,
    index: torch.Tensor,    # () or (B,) int32: the *first* new token's position
    *,
    window: int | None = None,  # linear caches only; ring caches pass None
    softcap: float | None = None,
    block_kv: int | None = None,
    pruned: bool = True,
    tables: torch.Tensor | None = None,  # (B, num_blocks) int32 block tables
    kv_len: int | None = None,           # logical cache length (paged only)
    k_scale: torch.Tensor | None = None,  # quantized caches: fp32 scales —
    v_scale: torch.Tensor | None = None,  # paged (P, K); dense (B, NP, K)
    scale_page: int | None = None,        # dense only: cache slots per scale row
) -> torch.Tensor:
    """One decode step over a live-block-pruned cache; see decode.py.

    With S > 1 q tokens (the widened-q variant) token s attends through
    cache slot index + s.  Each q row runs the same online softmax over the
    same block walk as a single-token call.  Passing `tables` selects the
    paged layout: K/V are one shared page pool and every request's cache
    blocks resolve through its block-table row.  With `k_scale`/`v_scale`
    the cache holds int8 / fp8 codes and every streamed block is
    dequantized at its page's scale (the quantized mode); a launch in that
    mode also counts in `flash_decode.quantized_launches`.
    """
    block_kv = DEFAULT_BLOCK_KV_DEC if block_kv is None else int(block_kv)
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, index, window=window,
                          softcap=softcap, block_kv=block_kv, pruned=pruned,
                          tables=tables, kv_len=kv_len, k_scale=k_scale,
                          v_scale=v_scale, scale_page=scale_page)
    if q.numel() == 0:
        return torch.empty_like(q)  # nothing to launch, nothing counted
    B = q.shape[0]
    index = index.to(torch.int32).reshape(-1).expand(B).contiguous()
    if tables is not None:
        tables = tables.to(torch.int32).contiguous()
    out = flash_decode_fwd(q, k_cache, v_cache, index, window=window,
                           softcap=softcap, block_kv=block_kv, pruned=pruned,
                           tables=tables, kv_len=kv_len, k_scale=k_scale,
                           v_scale=v_scale, scale_page=scale_page)
    flash_decode.launches += 1
    if k_scale is not None:
        flash_decode.quantized_launches += 1
    return out


flash_decode.launches = 0  # kernel launches made through this wrapper
flash_decode.quantized_launches = 0  # of which in the quantized-pool mode
