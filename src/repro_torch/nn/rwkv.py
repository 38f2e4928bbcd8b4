"""RWKV6 "Finch" blocks (arXiv:2404.05892): attention-free LM with
data-dependent decay.

TimeMix: token-shift with data-dependent low-rank interpolation (ddlerp) for
the r/k/v/w/g streams, per-channel decay w_t = exp(-exp(ww_t)) from a
low-rank MLP, and the per-head WKV linear-attention recurrence

    y_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

ChannelMix: token-shift + squared-ReLU MLP with a sigmoid receptance gate.

The WKV implementation is woven (ANTAREX kernel aspect),
`ctx.impl("wkv", "chunked")`: `"scan"` (the sequential plain version),
`"chunked"` (the chunked parallel plain version), `"proj_only"` (the
projections alone, the recurrence skipped) or `"cuda"` (the hand-written
kernel, `kernels/rwkv6`; the reference's `"pallas"`).  A single step
(S == 1, decode) takes the sequential plain version in every weave.  Decode
carries (x_prev, S) state and is O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_scan
from repro_torch.nn.blocks import GroupNorm, Linear
from repro_torch.nn.module import Ctx, Module, ParamSpec, cast

DDLERP_RANK = 32
DECAY_RANK = 64
STREAMS = ("w", "k", "v", "r", "g")


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """Shift sequence right by one; slot 0 gets x_prev (decode carry) or 0."""
    B, S, D = x.shape
    if S == 1:
        if x_prev is None:
            return torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
        return x_prev[:, None].to(x.dtype)
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev is not None:
        shifted[:, 0] = x_prev.to(x.dtype)
    return shifted


class TimeMix(Module):
    kind = "rwkv_time_mix"

    def __init__(self, name: str, d_model: int, head_dim: int = 64):
        super().__init__()
        self.name = name
        self.d_model, self.head_dim = d_model, head_dim
        assert d_model % head_dim == 0
        self.num_heads = d_model // head_dim
        d = d_model
        self.wr = Linear("wr", d, d, axes=("embed", "heads"), out_axes=("batch", "seq_act", "heads"))
        self.wk = Linear("wk", d, d, axes=("embed", "heads"), out_axes=("batch", "seq_act", "heads"))
        self.wv = Linear("wv", d, d, axes=("embed", "heads"), out_axes=("batch", "seq_act", "heads"))
        self.wg = Linear("wg", d, d, axes=("embed", "heads"), out_axes=("batch", "seq_act", "heads"))
        self.wo = Linear("wo", d, d, axes=("heads", "embed"), out_axes=("batch", "res_seq", "embed"))
        self.norm = GroupNorm("norm", self.num_heads, d)

    def spec(self):
        d = self.d_model
        return {
            "maa_x": ParamSpec((d,), ("embed",), init="normal", scale=0.1),
            "maa": ParamSpec((5, d), (None, "embed"), init="normal", scale=0.1),
            "maa_w1": ParamSpec((d, 5 * DDLERP_RANK), ("embed", None), init="normal",
                                scale=0.01),
            "maa_w2": ParamSpec((5, DDLERP_RANK, d), (None, None, "embed"), init="normal",
                                scale=0.01),
            "decay": ParamSpec((d,), ("embed",), init="normal", scale=0.5,
                               dtype=torch.float32),
            "decay_w1": ParamSpec((d, DECAY_RANK), ("embed", None), init="normal",
                                  scale=0.01),
            "decay_w2": ParamSpec((DECAY_RANK, d), (None, "embed"), init="normal",
                                  scale=0.01),
            "u": ParamSpec((self.num_heads, self.head_dim), ("heads", None),
                           init="normal", scale=0.5, dtype=torch.float32),
            "wr": self.wr, "wk": self.wk, "wv": self.wv, "wg": self.wg, "wo": self.wo,
            "norm": self.norm,
        }

    def forward(self, params, x, *, ctx: Ctx, state: dict | None = None,
                mode: str = "dense"):
        """state: {"x_prev": (B,D) fp32, "wkv": (B,H,hd,hd) fp32}."""
        with ctx.scope(self.name):
            policy = ctx.policy()
            cdt = policy.compute_dtype
            B, S, D = x.shape
            H, hd = self.num_heads, self.head_dim
            x_prev = state["x_prev"] if state is not None else None
            xx = _token_shift(x, x_prev) - x

            # ddlerp: data-dependent interpolation amounts for the 5 streams
            xxx = x + xx * cast(params["maa_x"], x.dtype)
            t = torch.tanh(torch.einsum("bsd,dr->bsr", cast(xxx, cdt),
                                        cast(params["maa_w1"], cdt)))
            t = t.reshape(B, S, 5, DDLERP_RANK)
            mix = torch.einsum("bsnr,nrd->nbsd", t, cast(params["maa_w2"], cdt))
            streams = {}
            for i, s in enumerate(STREAMS):
                m = cast(params["maa"][i], x.dtype) + cast(mix[i], x.dtype)
                streams[s] = x + xx * m

            r = self.wr(params["wr"], streams["r"], ctx=ctx).reshape(B, S, H, hd)
            k = self.wk(params["wk"], streams["k"], ctx=ctx).reshape(B, S, H, hd)
            v = self.wv(params["wv"], streams["v"], ctx=ctx).reshape(B, S, H, hd)
            g = F.silu(self.wg(params["wg"], streams["g"], ctx=ctx))

            ww = params["decay"] + torch.einsum(
                "bsr,rd->bsd",
                torch.tanh(torch.einsum("bsd,dr->bsr", cast(streams["w"], cdt),
                                        cast(params["decay_w1"], cdt))),
                cast(params["decay_w2"], cdt),
            ).to(torch.float32)
            w = torch.exp(-torch.exp(torch.clamp(ww, -60.0, 20.0)))  # (B,S,D) in (0,1)
            w = w.reshape(B, S, H, hd)

            s0 = state["wkv"] if state is not None else torch.zeros(
                (B, H, hd, hd), dtype=torch.float32, device=x.device)
            u = params["u"]

            impl = ctx.impl("wkv", "chunked")
            if impl == "proj_only":
                # the projections alone (tiny k/v/w mix keeps them in the result)
                y = r + 1e-30 * (k + v + w.to(r.dtype))
                s_last = s0
            elif impl == "cuda" and S > 1:
                from repro_torch.kernels.rwkv6.ops import wkv

                # the woven `wkv_chunk` tiles the reference's chunked TPU
                # kernel; the sequential CUDA kernel has no chunks to size
                y, s_last = wkv(r, k, v, w, u, s0)
            elif impl == "scan" or S == 1:
                y, s_last = wkv_scan(r, k, v, w, u, s0)
            else:
                y, s_last = wkv_chunked(r, k, v, w, u, s0,
                                        chunk=int(ctx.extra.get("wkv_chunk", 32)))

            y = self.norm(params["norm"], y.reshape(B, S, D), ctx=ctx)
            out = self.wo(params["wo"], y * g, ctx=ctx)
            new_state = {"x_prev": x[:, -1].to(torch.float32), "wkv": s_last}
            return out, new_state


class ChannelMix(Module):
    kind = "rwkv_channel_mix"

    def __init__(self, name: str, d_model: int, d_ff: int):
        super().__init__()
        self.name = name
        self.d_model, self.d_ff = d_model, d_ff
        self.wk = Linear("wk", d_model, d_ff, axes=("embed", "mlp"),
                         out_axes=("batch", "seq_act", "mlp"))
        self.wv = Linear("wv", d_ff, d_model, axes=("mlp", "embed"),
                         out_axes=("batch", "res_seq", "embed"))
        self.wr = Linear("wr", d_model, d_model, axes=("embed", None))

    def spec(self):
        d = self.d_model
        return {
            "maa_k": ParamSpec((d,), ("embed",), init="normal", scale=0.1),
            "maa_r": ParamSpec((d,), ("embed",), init="normal", scale=0.1),
            "wk": self.wk, "wv": self.wv, "wr": self.wr,
        }

    def forward(self, params, x, *, ctx: Ctx, state: dict | None = None,
                mode: str = "dense"):
        """state: {"x_prev": (B,D) fp32}."""
        with ctx.scope(self.name):
            x_prev = state["x_prev"] if state is not None else None
            xx = _token_shift(x, x_prev) - x
            xk = x + xx * cast(params["maa_k"], x.dtype)
            xr = x + xx * cast(params["maa_r"], x.dtype)
            k = self.wk(params["wk"], xk, ctx=ctx)
            k = torch.square(F.relu(k))
            kv = self.wv(params["wv"], k, ctx=ctx)
            out = torch.sigmoid(self.wr(params["wr"], xr, ctx=ctx)) * kv
            new_state = {"x_prev": x[:, -1].to(torch.float32)}
            return out, new_state


def rwkv_state_spec(batch: int, d_model: int, head_dim: int = 64):
    """{leaf: (shape, dtype)} of one layer's decode state (time + channel)."""
    H = d_model // head_dim
    return {
        "time": {
            "x_prev": ((batch, d_model), torch.float32),
            "wkv": ((batch, H, head_dim, head_dim), torch.float32),
        },
        "channel": {"x_prev": ((batch, d_model), torch.float32)},
    }
