"""Binding of the CUDA WKV kernel (`csrc/wkv6.cu`).

Replaces the reference's `wkv_fwd`.  The kernel reads r / k / v / w in the
model layout (B, S, H, C) and runs the chunked parallel form over chunks of
`CHUNK` steps, every chunk a block of its own: each chunk's state increment,
then the states entering the chunks (a scan over chunks, one thread per
state element), then each chunk's output.  A ragged last chunk needs no
padding from the caller.  One call is three CUDA launches; the wrapper
counts it once.  Its plain twin is `ref.wkv_chunk_parallel`."""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIM = 64  # the kernel's one head size
CHUNK = 32     # steps of a chunk: `kWkvChunk` of wkv6.cu, which refuses another


def wkv_fwd(r, k, v, w, u, s0):
    """r, k, v: (B, S, H, C) bf16 or fp32 (one dtype); w: (B, S, H, C) fp32;
    u: (H, C) fp32; s0: (B, H, C, C) fp32, all on the card and contiguous.
    Returns (y (B,S,H,C) in r's dtype, s_last (B,H,C,C) fp32)."""
    tensors = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    if not all(x.is_cuda and x.device == r.device for _, x in tensors):
        raise ValueError("wkv_fwd takes tensors on one CUDA device")
    code = build.dtype_code(r.dtype)
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, C), got {tuple(r.shape)}")
    B, S, H, C = r.shape
    if C != HEAD_DIM:
        raise ValueError(f"the WKV kernel takes head size {HEAD_DIM}, got {C}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, r {tuple(r.shape)}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype: {r.dtype}, {k.dtype}, {v.dtype}")
    for name, x, shape in (("w", w, r.shape), ("u", u, (H, C)), ("s0", s0, (B, H, C, C))):
        if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be float32 of shape {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if not all(x.is_contiguous() for _, x in tensors):
        raise ValueError("wkv_fwd takes contiguous tensors")
    if B * S * H == 0:
        raise ValueError("empty input: there is nothing to launch")
    n = -(-S // CHUNK)
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    # fp32 scratch: each chunk's state increment, then the state entering it,
    # and each chunk's decay
    states = torch.empty((B, H, n, C, C), dtype=torch.float32, device=r.device)
    decay = torch.empty((B, H, n, C), dtype=torch.float32, device=r.device)
    err = build.library().repro_torch_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_last.data_ptr(), states.data_ptr(),
        decay.data_ptr(), code, B, S, H, CHUNK,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check_launch(err, "wkv6")
    return y, s_last
