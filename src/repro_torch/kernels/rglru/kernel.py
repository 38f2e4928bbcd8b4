"""Binding of the CUDA RG-LRU scan (`csrc/rglru.cu`).

Replaces the reference's `rglru_fwd`.  The kernel tiles channels into slabs,
one block each, and streams each slab's time steps through a ring of tiles
in shared memory, walking every channel in order with its state in a
register.  Slab, tile and ring depth are compiled in and a ragged slab or
time tail is masked in the kernel, so nothing is padded and the reference's
`block_d` / `chunk` knobs size nothing here.  One launch a call."""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def rglru_fwd(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b: (B, S, D) fp32 on the card; h0: (B, D) fp32.
    Returns (y (B,S,D) fp32, h_last (B,D) fp32)."""
    if not (a.is_cuda and b.is_cuda and h0.is_cuda
            and a.device == b.device == h0.device):
        raise ValueError("rglru_fwd takes tensors on one CUDA device")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must share one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, S, D = a.shape
    if h0.shape != (B, D):
        raise ValueError(f"h0 must have shape ({B}, {D}), got {tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b), ("h0", h0)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {x.dtype}")
    if B * S * D == 0:
        raise ValueError("empty input: there is nothing to launch")
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    err = build.library().repro_torch_rglru(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        B, S, D, torch.cuda.current_stream(a.device).cuda_stream)
    build.check_launch(err, "rglru")
    return y, h_last
