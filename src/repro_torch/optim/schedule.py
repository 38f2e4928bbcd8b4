"""Learning-rate schedules (fp32, as the reference computes them)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32).detach().cpu()


def warmup_cosine(step, *, peak: float = 3e-4, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak: float = 3e-4, **_) -> torch.Tensor:
    return torch.full_like(_f32(step), peak)
