"""Core neural blocks: linear/embedding/norms/MLP variants/RoPE.

Every block reads its dtype policy from the woven Ctx (ANTAREX precision
aspects), passes activations through the (inert) sharding constraints, and
can emit monitoring taps.

On a live mesh a block is handed its rank's parameter blocks and reads its
parallel form from their shapes, as Megatron's layout puts it: a `Linear`
whose output dim is split is column-parallel (its replicated input enters
through `collectives.copy_to`), one whose input dim is split is
row-parallel (its partial products add over `model`); a vocab-split
`Embedding` looks up the ids of its rows and adds over `model`, and its
tied head gives the rank's vocab block of the logits.  Under an FSDP
layout a block is handed its parameters with their `embed` dims already
gathered (`models/lm.py`, `nn/stack.py`), so these shape tests read
Megatron's splits alone: a weight whose `embed` (input) dim were still an
FSDP block would read as row-parallel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_reduce, copy_to, reduce_from
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

    def forward(self, params, x, *, ctx: Ctx, entered: bool = False):
        """`entered`: x already went through `copy_to` (the MLP's two
        column-parallel products share one), or its gradient is summed over
        `model` where it was made (the sequence gathered under `fsdp_sp`)."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            w = params["w"]
            row = w.shape[-2] != self.d_in  # input dim split over model
            if w.shape[-1] != self.d_out and not entered:
                x = copy_to(x, ctx.mesh, "model")
            if policy.quantized:
                # a row-parallel block quantizes its rows at the scales of
                # the whole weight's columns, and its fp32 partial products
                # add over `model` before the one scaling
                mesh = ctx.mesh if row else None
                w, scale = _quantize_int8(w, mesh)
                y = _int8_matmul(cast(x, policy.compute_dtype), w, scale, policy, mesh)
            elif row:
                y = row_parallel_matmul(cast(x, policy.compute_dtype),
                                        cast(w, policy.compute_dtype), ctx)
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


def row_parallel_matmul(x, w, ctx: Ctx) -> torch.Tensor:
    """x @ w for w's rows split over `model` (this rank's block), summed
    over the ranks; a 3-D `w` (the MoE experts, (E, rows, n)) is a batched
    product of x (E, N, rows).  Served (no autograd), a 16-bit product
    keeps its fp32 partial sums for the all-reduce, so the result is
    rounded once, as the one-device product rounds its whole sum; under
    autograd the 16-bit partials are summed (in fp32 over gloo)."""
    if x.dtype in (torch.bfloat16, torch.float16) and not (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        y = _fp32_product(x, w)
    else:
        y = torch.matmul(x, w)
    return reduce_from(y, ctx.mesh, "model")


def _fp32_product(x, w) -> torch.Tensor:
    """x @ w of 16-bit operands with an fp32 result, rounded once: on the
    card the GEMM's fp32 sums unrounded, on the CPU the 16-bit values
    multiplied in fp32.  A 3-D `w` is a batched product of x (E, N, rows)."""
    if x.is_cuda and w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _quantize_int8(w: torch.Tensor, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization (paper's 'fixed').
    `mesh`: `w` is this rank's block of rows of a weight split over
    `model`; each column's |max| is taken over every rank's rows (an
    all-reduce with `max`, exact), so the codes and scales are the
    one-device ones for these rows, bit for bit."""
    wf = w.to(torch.float32)
    absmax = all_reduce(torch.amax(torch.abs(wf), dim=0, keepdim=True), mesh, "model",
                        op="max")
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_matmul(x, wq, scale, policy, mesh=None):
    """x @ wq with an fp32 result (`_fp32_product`), scaled in fp32, as the
    reference asks for its product in the accumulation dtype
    (`preferred_element_type`).  `mesh`: wq holds this rank's rows, and the
    partial products add over `model` before the scaling."""
    x, wq = x.to(policy.compute_dtype), wq.to(policy.compute_dtype)
    y = _fp32_product(x, wq) if x.dtype in (torch.bfloat16, torch.float16) \
        else torch.matmul(x, wq)
    y = reduce_from(y.to(policy.accum_dtype), mesh, "model")
    return y * scale.to(policy.accum_dtype)


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
            ids = torch.remainder(tokens, self.vocab)
            rows = table.shape[0]
            if rows != self.vocab:  # this rank's block of the vocab
                ids = ids - ctx.mesh.coord("model") * rows
                mine = (ids >= 0) & (ids < rows)
                x = F.embedding(torch.where(mine, ids, torch.zeros_like(ids)), table)
                x = reduce_from(x.masked_fill(~mine[..., None], 0), ctx.mesh, "model")
            else:
                x = F.embedding(ids, table)
            outside = (tokens < -self.vocab) | (tokens >= self.vocab)
            x = x.masked_fill(outside[..., None], float("nan"))
            if self.scale_by_dim:
                x = x * torch.tensor(np.sqrt(self.dim), dtype=policy.compute_dtype,
                                     device=x.device)
            return ctx.constrain(x, ("batch", "res_seq", "embed"))

    def attend(self, params, x, *, ctx: Ctx, entered: bool = False):
        """Logits = x @ table.T (tied output head), in the accumulation
        dtype; on a vocab-split table, this rank's block of them.
        `entered`: x's gradient is already summed over `model` where it was
        made (the sequence gathered under `fsdp_sp`), so no `copy_to`."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            table = cast(params["table"], policy.compute_dtype)
            if table.shape[0] != self.vocab and not entered:
                x = copy_to(x, ctx.mesh, "model")
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
            entered = params["wi"]["w"].shape[-1] != self.d_ff
            if entered:  # one copy_to for both column-parallel products
                x = copy_to(x, ctx.mesh, "model")
            h = self.wi(params["wi"], x, ctx=ctx, entered=entered)
            if self.wg is not None:
                g = self.wg(params["wg"], x, ctx=ctx, entered=entered)
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


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings for arbitrary positions: fp32
    angles, [sin | cos] on the last axis."""
    half = dim // 2
    step = np.log(10000.0) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * np.float32(step))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
