"""Public wrapper for the RG-LRU scan.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other.  The kernel
is forward-only: under autograd it raises (`build.refuse_grad`)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru.kernel import rglru_fwd
from repro_torch.kernels.rglru.ref import rglru_scan


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b: (B, S, D); h0: (B, D). Returns (h_seq (B,S,D) fp32, h_last (B,D))."""
    build.refuse_grad("rglru", a, b, h0)
    a, b, h0 = (x.to(torch.float32) for x in (a, b, h0))
    if a.device.type == "cpu":
        return rglru_scan(a, b, h0)
    if a.numel() == 0:  # nothing to launch, nothing counted
        return torch.empty_like(a), h0.clone()
    out = rglru_fwd(a.contiguous(), b.contiguous(), h0.contiguous())  # launches or raises
    rglru.launches += 1
    return out


rglru.launches = 0  # kernel launches made through this wrapper
