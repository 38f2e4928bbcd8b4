"""RecurrentGemma / Griffin recurrent block: temporal conv + RG-LRU.

RG-LRU (Real-Gated Linear Recurrent Unit, arXiv:2402.19427):
    r_t = sigmoid(BlockDiag_a(x_t))          (recurrence gate)
    i_t = sigmoid(BlockDiag_x(x_t))          (input gate)
    log a_t = -c * softplus(Lambda) * r_t    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through the woven implementation —
`ctx.impl("rglru", "assoc")`: `"assoc"` (the log-depth associative scan,
plain PyTorch), `"scan"` (the step-by-step plain version) or `"cuda"` (the
hand-written scan kernel, `kernels/rglru`; the reference's `"pallas"`).
Decode is the O(1) single-step update in every weave.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru.ref import rglru_assoc, rglru_scan
from repro_torch.nn.blocks import Linear
from repro_torch.nn.module import Ctx, Module, ParamSpec, cast

RGLRU_C = 8.0


class BlockDiagonalLinear(Module):
    kind = "linear"

    def __init__(self, name: str, dim: int, num_blocks: int):
        super().__init__()
        self.name = name
        self.dim, self.num_blocks = dim, num_blocks
        assert dim % num_blocks == 0
        self.block = dim // num_blocks

    def spec(self):
        nb, bs = self.num_blocks, self.block
        return {
            "w": ParamSpec((nb, bs, bs), (None, None, None), init="scaled", scale=bs),
            "b": ParamSpec((nb, bs), (None, None), init="zeros"),
        }

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            policy = ctx.policy()
            shape = x.shape
            # fp32 math: these are recurrence gates (small block-diagonal products)
            xb = x.to(torch.float32).reshape(*shape[:-1], self.num_blocks, self.block)
            y = torch.einsum("...ni,nij->...nj", xb, params["w"].to(torch.float32))
            y = y + params["b"].to(torch.float32)
            return cast(y, policy.compute_dtype).reshape(shape)


class RGLRU(Module):
    kind = "rglru"

    def __init__(self, name: str, dim: int, num_heads: int):
        super().__init__()
        self.name = name
        self.dim, self.num_heads = dim, num_heads
        self.gate_a = BlockDiagonalLinear("gate_a", dim, num_heads)
        self.gate_x = BlockDiagonalLinear("gate_x", dim, num_heads)

    def spec(self):
        return {
            "lam": ParamSpec((self.dim,), ("embed",), init="normal", scale=0.5,
                             dtype=torch.float32),
            "gate_a": self.gate_a,
            "gate_x": self.gate_x,
        }

    def _coeffs(self, params, x, ctx):
        """Per-step a_t (decay) and b_t (gated input), fp32."""
        r = torch.sigmoid(self.gate_a(params["gate_a"], x, ctx=ctx).to(torch.float32))
        i = torch.sigmoid(self.gate_x(params["gate_x"], x, ctx=ctx).to(torch.float32))
        log_a = -RGLRU_C * F.softplus(params["lam"]) * r
        a = torch.exp(log_a)
        mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        b = mult * (i * x.to(torch.float32))
        return a, b

    def forward(self, params, x, *, ctx: Ctx, state: torch.Tensor | None = None,
                mode: str = "dense"):
        """x: (B,S,D). Returns (y, final_state). state: (B,D) fp32."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            B, S, D = x.shape
            a, b = self._coeffs(params, x, ctx)
            if state is None:
                state = torch.zeros((B, D), dtype=torch.float32, device=x.device)

            if mode == "decode":  # S == 1: one fused step
                h = a[:, 0] * state + b[:, 0]
                return cast(h[:, None], policy.compute_dtype), h

            impl = ctx.impl("rglru", "assoc")
            if impl == "cuda":
                from repro_torch.kernels.rglru.ops import rglru

                # the reference's woven `rglru_block_d` / `rglru_chunk` tile
                # its TPU kernel; the CUDA scan's slab and tile are compiled
                # in, so the extras are accepted and have nothing to set
                h_seq, h_last = rglru(a, b, state)
            elif impl == "scan":
                h_seq, h_last = rglru_scan(a, b, state)
            else:
                h_seq, h_last = rglru_assoc(a, b, state)
            return cast(h_seq, policy.compute_dtype), h_last


class Conv1D(Module):
    """Causal depthwise temporal conv (width 4), with decode state."""

    kind = "conv"

    def __init__(self, name: str, dim: int, width: int = 4):
        super().__init__()
        self.name = name
        self.dim, self.width = dim, width

    def spec(self):
        return {
            "w": ParamSpec((self.width, self.dim), (None, "embed"), init="scaled",
                           scale=self.width),
            "b": ParamSpec((self.dim,), ("embed",), init="zeros"),
        }

    def forward(self, params, x, *, ctx: Ctx, state: torch.Tensor | None = None,
                mode: str = "dense"):
        """x: (B,S,D); state: (B,width-1,D). Returns (y, new_state)."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            B, S, D = x.shape
            w = cast(params["w"], policy.compute_dtype)
            xc = cast(x, policy.compute_dtype)
            W = self.width
            if state is None:
                state = torch.zeros((B, W - 1, D), dtype=xc.dtype, device=x.device)
            full = torch.cat([cast(state, xc.dtype), xc], dim=1)  # (B, S+W-1, D)
            y = sum(full[:, i : i + S] * w[i] for i in range(W))
            y = y + cast(params["b"], policy.compute_dtype)
            # a copy, not a view: the state must not keep the whole prompt alive
            new_state = full[:, -(W - 1):].clone()
            return y, new_state


class RecurrentBlock(Module):
    """Griffin temporal-mixing block: (linear->conv->RG-LRU) * gelu(linear) -> linear."""

    kind = "recurrent"

    def __init__(self, name: str, d_model: int, lru_width: int, num_heads: int,
                 conv_width: int = 4):
        super().__init__()
        self.name = name
        self.d_model, self.lru_width = d_model, lru_width
        self.num_heads = num_heads
        self.proj_x = Linear("proj_x", d_model, lru_width, axes=("embed", "heads"),
                             out_axes=("batch", "seq_act", "heads"))
        self.proj_y = Linear("proj_y", d_model, lru_width, axes=("embed", "heads"),
                             out_axes=("batch", "seq_act", "heads"))
        self.conv = Conv1D("conv", lru_width, conv_width)
        self.rglru = RGLRU("rglru", lru_width, num_heads)
        self.proj_out = Linear("proj_out", lru_width, d_model, axes=("heads", "embed"),
                               out_axes=("batch", "res_seq", "embed"))

    def spec(self):
        return {
            "proj_x": self.proj_x,
            "proj_y": self.proj_y,
            "conv": self.conv,
            "rglru": self.rglru,
            "proj_out": self.proj_out,
        }

    def init_state(self, batch: int, device):
        return {
            "conv": torch.zeros((batch, self.conv.width - 1, self.lru_width),
                                dtype=torch.bfloat16, device=device),
            "lru": torch.zeros((batch, self.lru_width), dtype=torch.float32, device=device),
        }

    @staticmethod
    def state_spec(batch: int, lru_width: int, conv_width: int = 4):
        """{leaf: (shape, dtype)} of one block's decode state."""
        return {
            "conv": ((batch, conv_width - 1, lru_width), torch.bfloat16),
            "lru": ((batch, lru_width), torch.float32),
        }

    def forward(self, params, x, *, ctx: Ctx, state: dict | None = None,
                mode: str = "dense"):
        with ctx.scope(self.name):
            y = F.gelu(self.proj_y(params["proj_y"], x, ctx=ctx), approximate="tanh")
            h = self.proj_x(params["proj_x"], x, ctx=ctx)
            conv_state = state["conv"] if state is not None else None
            lru_state = state["lru"] if state is not None else None
            h, new_conv = self.conv(params["conv"], h, ctx=ctx, state=conv_state, mode=mode)
            h, new_lru = self.rglru(params["rglru"], h, ctx=ctx, state=lru_state, mode=mode)
            out = self.proj_out(params["proj_out"], h * y, ctx=ctx)
            new_state = {"conv": new_conv, "lru": new_lru}
            return out, new_state
