"""Public wrapper for fused RMSNorm.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other.  The kernel
is forward-only: under autograd it raises (`build.refuse_grad`)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    build.refuse_grad("rmsnorm", x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.numel() == 0:
        return torch.empty_like(x)  # nothing to launch, nothing counted
    out = rmsnorm_fwd(x, w, eps=eps)  # launches or raises
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0  # kernel launches made through this wrapper
