"""Binding of the CUDA RMSNorm kernel (`csrc/rmsnorm.cu`).

Replaces the reference's `rmsnorm_fwd`: one read, one write, fp32 math.  The
kernel takes rows as they come — there is no padding to a block of rows."""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) bf16/fp32 on the card, w: (d,) fp32 -> same shape/dtype as x."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rmsnorm_fwd takes tensors on one CUDA device")
    code = build.dtype_code(x.dtype)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w must be contiguous float32 of shape ({d},), "
                         f"got {w.dtype} {tuple(w.shape)}")
    if d % 8 or d < 8:
        raise ValueError(f"feature dim {d} must be a positive multiple of 8")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("empty x: there is nothing to launch")
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    err = build.library().repro_torch_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), code, rows, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, "rmsnorm")
    return out
