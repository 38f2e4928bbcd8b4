"""Public wrapper for the RWKV6 WKV recurrence.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other.  The kernel
is forward-only: under autograd it raises (`build.refuse_grad`)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6.kernel import wkv_fwd
from repro_torch.kernels.rwkv6.ref import wkv_scan


def wkv(r, k, v, w, u, s0):
    """r, k, v, w: (B,S,H,C); u: (H,C); s0: (B,H,C,C). Returns (y, s_last):
    y in r's dtype, s_last fp32."""
    build.refuse_grad("wkv", r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv_scan(r, k, v, w, u, s0)
    if r.numel() == 0:  # nothing to launch, nothing counted
        return torch.empty_like(r), s0.to(torch.float32).clone()
    out = wkv_fwd(r.contiguous(), k.contiguous(), v.contiguous(),
                  w.to(torch.float32).contiguous(), u.to(torch.float32).contiguous(),
                  s0.to(torch.float32).contiguous())  # launches or raises
    wkv.launches += 1
    return out


wkv.launches = 0  # kernel launches made through this wrapper
