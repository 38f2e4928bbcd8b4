"""Mixture-of-Experts feed-forward (mixtral / grok style: 8 experts, top-2).

Dispatch is the reference's capacity-based einsum formulation: tokens are
grouped (bounded sequence groups of each batch row), each token's top-k
experts get a one-hot (expert, capacity-slot) assignment, and dispatch /
combine are dense products.  Tokens overflowing an expert's capacity are
dropped; the `moe_capacity_factor` extra sets the trade-off (the ANTAREX
autotuner's knob) and `moe_group_size` bounds a group.

Every decision the server relies on follows the reference exactly: the
router runs in fp32, top-k breaks ties toward the lower expert index (as
`jax.lax.top_k` does), ranks are an exclusive cumulative sum in token-major
order, and a dropped token (rank >= C) gets an all-zero capacity row, so it
contributes exactly nothing.  The products are left to cuBLAS, as the
reference leaves them to XLA: no kernel of this module replaces a TPU
kernel.

On a live mesh under Megatron's layout (the experts replicated, tensor
parallelism inside them, as GSPMD splits the reference's `wi` / `wg` / `wo`)
a rank holds every expert's block of the `mlp` dim: `wi` / `wg` are
column-parallel and `wo` row-parallel, with one all-reduce over `model`
after it.  The router, the capacities and the combine stay replicated, so
every rank routes alike.  The router reads the residual as it is: only the
experts' branch enters through `copy_to`, whose backward sums the
gradient over `model` — the router's share of it is whole on every rank
already.  The all-reduce comes after `wo`, not after the combine, so the
gates see whole expert outputs and their gradient needs no sum of its own.

Under `fsdp_sp` (`sharding.seq_axis`) a rank holds its block of the
sequence, and the experts whole (or FSDP blocks gathered at use).  The
layer gathers the sequence over the axis (`gather_from`), groups, routes
and runs the experts on it, and keeps its block of the output, as
attention does in this layout.  A group then spans the ranks' blocks as it
spans the whole sequence on one device (`group_size` and `capacity` read
the global length), each token's capacity rank is its place in the
cumulative sum over the whole group, so its keep mask is bit for bit the
unmeshed layer's, and the `moe_drop_frac` tap is the global share on every
rank.  (Adding the lower ranks' per-expert counts to a local cumulative sum
would route alike with less work, but it is a second routing path that has
to agree with this one bit for bit; the gather keeps one.)  The gather's
backward sums the ranks' gradients and hands each its block: a token's
output depends on its own input alone (the capacity ranks are
discrete), so each rank's gradient is its block's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.collectives import copy_to, gather_from
from repro_torch.distributed.sharding import seq_axis
from repro_torch.nn.blocks import _act, row_parallel_matmul
from repro_torch.nn.module import Ctx, Module, ParamSpec, cast


def top_k_lower_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, largest first, equal values
    in ascending index order — `jax.lax.top_k`'s order; `torch.topk`
    promises none."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def group_size(S: int, grp: int) -> int:
    """The largest group of at most `grp` tokens that divides S."""
    grp = max(1, min(grp, S))
    while S % grp:
        grp -= 1
    return grp


def capacity(grp: int, top_k: int, cf: float, num_experts: int) -> int:
    """Slots per expert and group: ceil(grp * K * cf / E), at least 1."""
    return max(int(np.ceil(grp * top_k * cf / num_experts)), 1)


class MoEMLP(Module):
    kind = "moe"

    def __init__(
        self,
        name: str,
        d_model: int,
        d_ff: int,
        *,
        num_experts: int,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        activation: str = "silu",
    ):
        super().__init__()
        self.name = name
        self.d_model, self.d_ff = d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.activation = activation

    def spec(self):
        E, dm, dff = self.num_experts, self.d_model, self.d_ff
        return {
            "router": ParamSpec((dm, E), ("embed", None), init="scaled", scale=dm),
            "wi": ParamSpec((E, dm, dff), ("experts", "embed", "mlp"), init="scaled", scale=dm),
            "wg": ParamSpec((E, dm, dff), ("experts", "embed", "mlp"), init="scaled", scale=dm),
            "wo": ParamSpec((E, dff, dm), ("experts", "mlp", "embed"), init="scaled", scale=dff),
        }

    def forward(self, params, x, *, ctx: Ctx):
        with ctx.scope(self.name):
            sp = seq_axis(ctx.mesh, ctx.rules)
            if sp is not None:  # fsdp_sp: route the whole sequence
                block = x.shape[1]
                out = self._experts(params, gather_from(x, ctx.mesh, sp, 1), ctx)
                return out.narrow(1, ctx.mesh.coord(sp) * block, block)
            return self._experts(params, x, ctx)

    def _experts(self, params, x, ctx: Ctx):
        """Group, route, dispatch to the experts and combine `x` (B, S, dm)."""
        policy = ctx.policy()
        B, S, dm = x.shape
        E, K = self.num_experts, self.top_k
        cf = float(ctx.extra.get("moe_capacity_factor", self.capacity_factor))
        # bounded dispatch groups: the one-hot products cost
        # O(tokens x E x C x d) with C proportional to the group
        grp = group_size(S, int(ctx.extra.get("moe_group_size", 2048)))
        n_groups = S // grp
        C = capacity(grp, K, cf, E)

        xc = cast(x, policy.compute_dtype)
        if n_groups > 1:
            xc = xc.reshape(B * n_groups, grp, dm)
        Bg, Sg = xc.shape[0], grp
        topg, tope, onehot, rank = self.route(params, xc, policy)
        keep = rank < C
        # the mean as the reference takes it: the sum times 1/n in fp32
        ctx.tap("moe_drop_frac", lambda: 1.0 - torch.sum(keep.to(torch.float32))
                * np.float32(1.0 / keep.numel()))

        gate_kept = torch.where(keep, topg, torch.zeros_like(topg))
        # a dropped token's rank (>= C) matches no slot: its row is zero
        slot_oh = (rank.to(torch.long)[..., None]
                   == torch.arange(C, device=x.device)).to(torch.float32)
        # combine[b,s,e,c] = sum_k gate * onehot_e * onehot_c (one term
        # at most: a token's k experts are distinct)
        combine = torch.einsum("bske,bskc->bsec", onehot * gate_kept[..., None], slot_oh)
        dispatch = (combine > 0).to(policy.compute_dtype)  # (Bg, Sg, E, C)
        combine = combine.to(policy.compute_dtype)

        # --- dispatch -> expert compute -> combine ---
        # the experts' mlp dim split over model: their branch enters
        # through copy_to (the router above read xc as it is)
        tp = params["wi"].shape[-1] != self.d_ff
        xe = copy_to(xc, ctx.mesh, "model") if tp else xc
        # expert_in[e,b,c] = the one token of group b in slot (e, c)
        expert_in = torch.matmul(
            dispatch.permute(0, 2, 3, 1).reshape(Bg, E * C, Sg), xe)
        expert_in = expert_in.reshape(Bg, E, C, dm).transpose(0, 1)
        expert_in = expert_in.reshape(E, Bg * C, dm)  # (E, Bg*C, dm)
        wi = cast(params["wi"], policy.compute_dtype)
        wg = cast(params["wg"], policy.compute_dtype)
        wo = cast(params["wo"], policy.compute_dtype)
        # products accumulate in fp32 inside the GEMM and come back in
        # the compute dtype, the cast the reference applies after them
        h = torch.bmm(expert_in, wi)
        g = torch.bmm(expert_in, wg)
        h = _act(self.activation, g) * h
        # (E, Bg*C, dm); row-parallel: the partial products add over model
        out_e = row_parallel_matmul(h, wo, ctx) if tp else torch.bmm(h, wo)
        out_e = cast(out_e, policy.compute_dtype)
        out_e = out_e.reshape(E, Bg, C, dm).transpose(0, 1).reshape(Bg, E * C, dm)
        out = torch.matmul(combine.reshape(Bg, Sg, E * C), out_e)
        if n_groups > 1:
            out = out.reshape(B, S, dm)
        return cast(out, policy.compute_dtype)

    def route(self, params, xc, policy):
        """Routing of grouped tokens `xc` (Bg, Sg, dm): the renormalised
        top-k gates and experts (Bg, Sg, K), the experts one-hot (Bg, Sg,
        K, E) fp32, and each (token, k)'s rank within its expert's group,
        as fp32 (an exclusive cumulative sum in token-major order)."""
        E, K = self.num_experts, self.top_k
        Bg, Sg = xc.shape[0], xc.shape[1]
        # fp32 logits: products of compute-dtype values summed in fp32, as
        # the reference's preferred_element_type gives
        router = cast(params["router"], policy.compute_dtype)
        logits = torch.matmul(xc.to(torch.float32), router.to(torch.float32))
        gates = torch.softmax(logits, dim=-1)  # (Bg, Sg, E)
        topg, tope = top_k_lower_index(gates, K)
        topg = topg / torch.sum(topg, dim=-1, keepdim=True)
        onehot = (tope[..., None] == torch.arange(E, device=xc.device)).to(torch.float32)
        flat = onehot.reshape(Bg, Sg * K, E)
        ranks = (torch.cumsum(flat, dim=1) - flat).reshape(Bg, Sg, K, E)
        return topg, tope, onehot, torch.sum(ranks * onehot, dim=-1)

    def active_params_per_token(self) -> int:
        """Parameters touched per token (router + top_k experts) for MODEL_FLOPS."""
        per_expert = self.d_model * self.d_ff * 3
        return self.d_model * self.num_experts + self.top_k * per_expert
