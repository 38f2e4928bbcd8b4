"""Core neural blocks: linear/embedding/norms/MLP variants/RoPE.

Every block reads its dtype policy from the woven Ctx (ANTAREX precision
aspects), passes activations through the (inert, single-card) sharding
constraints, and can emit monitoring taps.  `sinusoidal_positions` arrives
with the family that uses it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.module import Ctx, Module, ParamSpec, cast


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------


class Linear(Module):
    """y = x @ w (+ b); w: (d_in, d_out) with logical axes."""

    kind = "linear"

    def __init__(
        self,
        name: str,
        d_in: int,
        d_out: int,
        *,
        axes: tuple[str | None, str | None],
        bias: bool = False,
        out_axes: tuple[str | None, ...] | None = None,
        init_scale: float | None = None,
    ):
        super().__init__()
        self.name = name
        self.d_in, self.d_out = d_in, d_out
        self.axes = axes
        self.bias = bias
        self.out_axes = out_axes
        self.init_scale = init_scale

    def spec(self):
        s: dict[str, Any] = {
            "w": ParamSpec(
                (self.d_in, self.d_out),
                self.axes,
                init="scaled",
                scale=self.init_scale or self.d_in,
            )
        }
        if self.bias:
            s["b"] = ParamSpec((self.d_out,), (self.axes[1],), init="zeros")
        return s

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            policy = ctx.policy()
            w = params["w"]
            if policy.quantized:
                w, scale = _quantize_int8(w)
                y = _int8_matmul(cast(x, policy.compute_dtype), w, scale, policy)
            else:
                # the product accumulates in fp32 inside the GEMM and comes
                # back in the compute dtype
                y = torch.matmul(cast(x, policy.compute_dtype),
                                 cast(w, policy.compute_dtype))
            if self.bias:
                y = cast(y, policy.accum_dtype) + cast(params["b"], policy.accum_dtype)
            y = cast(y, policy.compute_dtype)
            if self.out_axes is not None:
                y = ctx.constrain(y, self.out_axes)
            ctx.tap("out_absmax", lambda: torch.max(torch.abs(y)))
            return y


def _quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization (paper's 'fixed')."""
    wf = w.to(torch.float32)
    absmax = torch.amax(torch.abs(wf), dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_matmul(x, wq, scale, policy):
    y = torch.matmul(x.to(policy.compute_dtype), wq.to(policy.compute_dtype))
    return y.to(policy.accum_dtype) * scale.to(policy.accum_dtype)


# ---------------------------------------------------------------------------
# Embedding (tied head supported by models calling `attend`)
# ---------------------------------------------------------------------------


class Embedding(Module):
    kind = "embedding"

    def __init__(self, name: str, vocab: int, dim: int, *, scale_by_dim: bool = False):
        super().__init__()
        self.name = name
        self.vocab, self.dim = vocab, dim
        self.scale_by_dim = scale_by_dim  # gemma multiplies by sqrt(dim)

    def spec(self):
        return {
            "table": ParamSpec(
                (self.vocab, self.dim), ("vocab", "embed"), init="embedding", scale=0.02
            )
        }

    def forward(self, params, tokens, *, ctx: Ctx):
        """Rows of the table, indexed as the reference's `jnp.take` in fill
        mode indexes them: an id in [-vocab, 0) counts from the end, and an
        id outside [-vocab, vocab) (a foreign draft model's token, say)
        gives a row of NaN.  No out-of-range id reaches `F.embedding`: on
        the card one would trip a device-side assert."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            table = cast(params["table"], policy.compute_dtype)
            # remainder lands every id in [0, vocab); the mask then blanks
            # the rows of ids that were outside [-vocab, vocab)
            x = F.embedding(torch.remainder(tokens, self.vocab), table)
            outside = (tokens < -self.vocab) | (tokens >= self.vocab)
            x = x.masked_fill(outside[..., None], float("nan"))
            if self.scale_by_dim:
                x = x * torch.tensor(np.sqrt(self.dim), dtype=policy.compute_dtype,
                                     device=x.device)
            return ctx.constrain(x, ("batch", "res_seq", "embed"))

    def attend(self, params, x, *, ctx: Ctx):
        """Logits = x @ table.T (tied output head), in the accumulation dtype."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            table = cast(params["table"], policy.compute_dtype)
            logits = torch.matmul(cast(x, policy.compute_dtype), table.T)
            logits = cast(logits, policy.accum_dtype)
            return ctx.constrain(logits, ("batch", "res_seq", "vocab"))


# ---------------------------------------------------------------------------
# Norms (fp32 params + fp32 math — standard for stability)
# ---------------------------------------------------------------------------


class RMSNorm(Module):
    kind = "norm"

    def __init__(self, name: str, dim: int, *, eps: float = 1e-6, plus_one: bool = False):
        super().__init__()
        self.name = name
        self.dim, self.eps = dim, eps
        self.plus_one = plus_one  # gemma parameterizes weight as (1 + w)

    def spec(self):
        init = "zeros" if self.plus_one else "ones"
        return {"w": ParamSpec((self.dim,), ("embed",), init=init, dtype=torch.float32)}

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            policy = ctx.policy()
            w = params["w"] + 1.0 if self.plus_one else params["w"]
            if ctx.impl("norm", "eager") == "cuda":
                # fused kernel (forward-only — woven for serving).  The
                # `rms_block_rows` extra tunes the reference's row tiling; the
                # CUDA kernel runs one block per row and has no such knob, so
                # the extra is accepted and ignored.
                from repro_torch.kernels.rmsnorm.ops import rmsnorm

                y = rmsnorm(x.contiguous(), w.contiguous(), eps=self.eps)
                return cast(y, policy.compute_dtype)
            xf = x.to(torch.float32)
            var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
            y = xf * torch.rsqrt(var + self.eps) * w
            ctx.tap("rms", lambda: torch.sqrt(torch.mean(var)))
            return cast(y, policy.compute_dtype)


class LayerNorm(Module):
    """Plain in every weave: the `"norm"` kind shares its joinpoints with
    `RMSNorm`, but only `RMSNorm` consults the woven impl (the RMSNorm kernel
    computes another function)."""

    kind = "norm"

    def __init__(self, name: str, dim: int, *, eps: float = 1e-5):
        super().__init__()
        self.name = name
        self.dim, self.eps = dim, eps

    def spec(self):
        return {
            "w": ParamSpec((self.dim,), ("embed",), init="ones", dtype=torch.float32),
            "b": ParamSpec((self.dim,), ("embed",), init="zeros", dtype=torch.float32),
        }

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            policy = ctx.policy()
            xf = x.to(torch.float32)
            mean = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
            y = (xf - mean) * torch.rsqrt(var + self.eps) * params["w"] + params["b"]
            return cast(y, policy.compute_dtype)


class GroupNorm(Module):
    """Per-head group norm (RWKV6 time-mixing output norm); plain in every
    weave, as `LayerNorm` is."""

    kind = "norm"

    def __init__(self, name: str, num_groups: int, dim: int, *, eps: float = 1e-5):
        super().__init__()
        self.name = name
        self.num_groups, self.dim, self.eps = num_groups, dim, eps

    def spec(self):
        return {
            "w": ParamSpec((self.dim,), ("embed",), init="ones", dtype=torch.float32),
            "b": ParamSpec((self.dim,), ("embed",), init="zeros", dtype=torch.float32),
        }

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            policy = ctx.policy()
            shape = x.shape
            xf = x.to(torch.float32).reshape(*shape[:-1], self.num_groups, -1)
            mean = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
            y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
            y = y * params["w"] + params["b"]
            return cast(y, policy.compute_dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


class MLP(Module):
    """Gated (llama/gemma) or plain (whisper/nemotron) feed-forward."""

    kind = "mlp"

    def __init__(
        self,
        name: str,
        d_model: int,
        d_ff: int,
        *,
        activation: str = "silu",
        gated: bool = True,
        bias: bool = False,
    ):
        super().__init__()
        self.name = name
        self.d_model, self.d_ff = d_model, d_ff
        self.activation, self.gated, self.bias = activation, gated, bias
        self.wi = Linear(
            "wi", d_model, d_ff, axes=("embed", "mlp"), bias=bias,
            out_axes=("batch", "seq_act", "mlp"),
        )
        self.wg = (
            Linear("wg", d_model, d_ff, axes=("embed", "mlp"), bias=bias,
                   out_axes=("batch", "seq_act", "mlp"))
            if gated
            else None
        )
        self.wo = Linear(
            "wo", d_ff, d_model, axes=("mlp", "embed"), bias=bias,
            out_axes=("batch", "res_seq", "embed"),
        )

    def spec(self):
        s: dict[str, Any] = {"wi": self.wi, "wo": self.wo}
        if self.wg is not None:
            s["wg"] = self.wg
        return s

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            h = self.wi(params["wi"], x, ctx=ctx)
            if self.wg is not None:
                g = self.wg(params["wg"], x, ctx=ctx)
                h = _act(self.activation, g) * h
            else:
                h = _act(self.activation, h)
            return self.wo(params["wo"], h, ctx=ctx)


# ---------------------------------------------------------------------------
# Rotary position embedding (functional)
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: int[...]; returns (sin, cos) of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim//2)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    s = sin[..., None, :]  # broadcast over heads
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
