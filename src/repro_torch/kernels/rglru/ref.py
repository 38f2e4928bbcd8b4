"""Plain PyTorch versions of the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.

`rglru_scan` is the step-by-step form — the function the CUDA kernel
computes, in the same order (one multiply, one add per step, fp32), and what
the kernel wrapper runs for a CPU tensor.  `rglru_assoc` is the log-depth
associative-scan form, the plain implementation the model takes when no
kernel is woven.  Both take fp32 (a, b) of shape (B, S, D) and an initial
state (B, D), and return (h_seq (B,S,D), h_last (B,D)).
"""

from __future__ import annotations

import torch


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    h = h0.to(torch.float32)
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def rglru_assoc(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Associative scan over composed affine maps (a, b)∘(a', b')=(aa', a'b+b'),
    Hillis-Steele style: log2(S) rounds, each composing every step with the
    one `offset` steps before it."""
    a = a.to(torch.float32)
    b = b.to(torch.float32).clone()
    # fold h0 into the first step: b_0' = a_0 h0 + b_0
    b[:, 0] = b[:, 0] + a[:, 0] * h0.to(torch.float32)
    S = a.shape[1]
    offset = 1
    while offset < S:
        a_prev, b_prev = a[:, :-offset], b[:, :-offset]
        a_cur, b_cur = a[:, offset:], b[:, offset:]
        b = torch.cat([b[:, :offset], b_prev * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :offset], a_prev * a_cur], dim=1)
        offset *= 2
    return b, b[:, -1]
