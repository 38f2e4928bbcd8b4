"""Whisper-style encoder-decoder backbone (the audio frontend is a stub: the
caller hands precomputed frame embeddings `frames`, (B, T, d_model)).

Encoder: bidirectional attention blocks over the frame embeddings plus
sinusoidal positions.  Decoder: causal self-attention, cross-attention to
the encoder states, MLP.  Both are layer stacks.  A prefill returns the
last token's logits and `{"decoder": ..., "enc": ...}`: per layer a linear
self-attention cache and the cross-attention `{"ck", "cv"}` (computed once
from the encoder states), and the encoder states themselves.  A decode
step reads `cache["enc"]`, writes the self caches in place and hands the
cross caches back unwritten.

Positions are sinusoidal (not learned), as in the reference; the backbone's
dimensions are whisper-small's.

On a live mesh under Megatron's layout each rank runs both stacks on its
heads and its block of the MLPs: the encoder non-causal, its output
replicated on every rank; the cross-attention's K / V (and their cache)
the rank's heads, projected from those states.  A vocab the `model` axis
does not divide (whisper-small's 51865 rows) stays whole on every rank.
Weights split on their `embed` dim (an FSDP rule) are gathered where they
are used, as the decoder-only LM gathers them (`sharding.gather_plan`).

Under `fsdp_sp` (`sharding.seq_axis`) each rank runs both stacks on its
block of the sequence, with the weights whole or FSDP blocks gathered at
use.  The encoder adds the sinusoidal positions to the whole frames and
keeps the rank's block of them (a plain slice: frames are an input, not a
weight); its non-causal attention gathers q / k / v over the axis
(`nn/attention.py`), and its output is gathered once over the axis
(`gather_from`, whose backward sums the ranks' gradient blocks) for every
decoder layer's cross-attention, whose q is the rank's block of tokens.
The decoder's embedded tokens take the rank's block as the decoder-only
LM's do (`lm.sequence_block`: a plain slice of a whole table's rows, or a
vocab-split table's rows with their gradient gathered back).  Frames the
axis does not divide stay whole on every rank, as the reference's
shape-guarded constraint leaves them: each rank runs the whole encoder,
and its gradient is then the rank's partial sum (it comes from the
rank's decoder block alone), which the train step's sum over the
sequence axis completes.  Decoder tokens the axis does not divide raise in
training.  In serving a prompt the axis does not divide, and a decode
step's tokens, are whole on every rank (`lm.serving_sequence`); the
caches are split over `kv_seq` where the axis divides their length
(`sharding.seq_share`): the self caches' slots, whose whole length the
model then carries as a hoisted `kv_pos` map as the decoder-only LM does,
and the cross caches' frames (whisper-small's 1500: 750 a rank on two
ranks), while the encoder states `enc` stay whole.
"""

from __future__ import annotations

import copy
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import gather_from
from repro_torch.distributed.sharding import gather_plan, gather_tree, kv_seq_axis, seq_axis
from repro_torch.models.lm import (advance_kv_pos, last_position, prefill_kv_pos,
                                   sequence_block, serving_sequence)
from repro_torch.nn.attention import Attention, cache_spec
from repro_torch.nn.blocks import MLP, Embedding, LayerNorm, sinusoidal_positions
from repro_torch.nn.module import Ctx, Module, cast
from repro_torch.nn.stack import ScannedStack


class EncoderBlock(Module):
    kind = "block"

    def __init__(self, name: str, cfg: ModelConfig):
        super().__init__()
        self.name = name
        self.norm1 = LayerNorm("norm1", cfg.d_model)
        self.attn = Attention("attn", cfg.d_model, cfg.n_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, use_rope=False, mask="full")
        self.norm2 = LayerNorm("norm2", cfg.d_model)
        self.ffn = MLP("ffn", cfg.d_model, cfg.d_ff, activation="gelu", gated=False,
                       bias=True)

    def spec(self):
        return {"norm1": self.norm1, "attn": self.attn, "norm2": self.norm2,
                "ffn": self.ffn}

    def forward(self, params, x, *, ctx: Ctx, mode="dense", cache=None,
                positions=None):
        with ctx.scope(self.name):
            h = self.norm1(params["norm1"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            h, _ = self.attn(params["attn"], h, ctx=ctx, positions=positions,
                             mode="dense")
            x = x + h
            h = self.norm2(params["norm2"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            x = x + self.ffn(params["ffn"], h, ctx=ctx)
            return x, None


class DecoderXBlock(Module):
    kind = "block"

    def __init__(self, name: str, cfg: ModelConfig):
        super().__init__()
        self.name = name
        self.norm1 = LayerNorm("norm1", cfg.d_model)
        self.self_attn = Attention("self_attn", cfg.d_model, cfg.n_heads,
                                   cfg.kv_heads, cfg.resolved_head_dim,
                                   use_rope=False, mask="causal")
        self.norm_x = LayerNorm("norm_x", cfg.d_model)
        self.cross_attn = Attention("cross_attn", cfg.d_model, cfg.n_heads,
                                    cfg.kv_heads, cfg.resolved_head_dim,
                                    use_rope=False, mask="full", cross=True)
        self.norm2 = LayerNorm("norm2", cfg.d_model)
        self.ffn = MLP("ffn", cfg.d_model, cfg.d_ff, activation="gelu", gated=False,
                       bias=True)

    def spec(self):
        return {"norm1": self.norm1, "self_attn": self.self_attn,
                "norm_x": self.norm_x, "cross_attn": self.cross_attn,
                "norm2": self.norm2, "ffn": self.ffn}

    def forward(self, params, x, *, ctx: Ctx, mode="dense", cache=None,
                positions=None, kv_src=None, kv_pos=None):
        with ctx.scope(self.name):
            self_cache = cache.get("self") if cache is not None else None
            cross_cache = cache.get("cross") if cache is not None else None
            h = self.norm1(params["norm1"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            h, self_new = self.self_attn(params["self_attn"], h, ctx=ctx,
                                         positions=positions, mode=mode,
                                         cache=self_cache, kv_pos=kv_pos)
            x = x + h
            h = self.norm_x(params["norm_x"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            h, cross_new = self.cross_attn(params["cross_attn"], h, ctx=ctx,
                                           cache=cross_cache, kv_src=kv_src,
                                           mode=mode)
            x = x + h
            h = self.norm2(params["norm2"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            x = x + self.ffn(params["ffn"], h, ctx=ctx)
            new_cache = None
            if mode != "dense":
                new_cache = {"self": self_new, "cross": cross_new}
            return x, new_cache


class EncDecLM(Module):
    kind = "model"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.name = cfg.name.replace("-", "_")
        self.cfg = cfg
        enc_layers = cfg.enc_layers or cfg.num_layers
        self.embed = Embedding("embed", cfg.vocab, cfg.d_model)
        self.encoder = ScannedStack("encoder", EncoderBlock("block", cfg), enc_layers)
        self.enc_norm = LayerNorm("enc_norm", cfg.d_model)
        self.decoder = ScannedStack("decoder", DecoderXBlock("block", cfg),
                                    cfg.num_layers)
        self.final_norm = LayerNorm("final_norm", cfg.d_model)

    def spec(self):
        return {
            "embed": self.embed,
            "encoder": self.encoder,
            "enc_norm": self.enc_norm,
            "decoder": self.decoder,
            "final_norm": self.final_norm,
        }

    def encode(self, params, frames, *, ctx: Ctx):
        """frames: (B, T, d_model) stub frame embeddings -> encoder states.
        Frames and positions are each cast to the compute dtype, then added.
        Under `fsdp_sp` the states are the whole encoder output on every
        rank (see the module's docstring)."""
        plan = gather_plan(self, ctx.mesh, ctx.rules)
        T = frames.shape[1]
        dtype = ctx.policy().compute_dtype
        pos = sinusoidal_positions(torch.arange(T, device=frames.device), self.cfg.d_model)
        x = cast(frames, dtype) + cast(pos, dtype)
        x = ctx.constrain(x, ("batch", "res_seq", "embed"))
        sp = seq_axis(ctx.mesh, ctx.rules)
        split = sp is not None and T % ctx.mesh.shape[sp] == 0
        if split:  # this rank's block of the frames
            size = T // ctx.mesh.shape[sp]
            x = x.narrow(1, ctx.mesh.coord(sp) * size, size)
        elif sp is not None:  # whole frames: no sequence split inside
            ctx = copy.copy(ctx)
            ctx.rules = {**ctx.rules, "res_seq": None, "seq_act": None}
        x, _ = self.encoder(params["encoder"], x, ctx=ctx, mode="dense",
                            gather=plan and plan["encoder"])
        x = self.enc_norm(gather_tree(params["enc_norm"], plan and plan["enc_norm"],
                                      ctx.mesh), x, ctx=ctx)
        return gather_from(x, ctx.mesh, sp, 1) if split else x

    def forward(self, params, inputs: dict, *, ctx: Ctx, mode: str = "dense",
                cache: dict | None = None):
        cfg = self.cfg
        tokens = inputs["tokens"]
        B, S = tokens.shape
        plan = gather_plan(self, ctx.mesh, ctx.rules)
        sp = seq_axis(ctx.mesh, ctx.rules)

        def whole(key):  # a top-level weight, its FSDP dims gathered at use
            return gather_tree(params[key], plan and plan[key], ctx.mesh)

        if ctx.extra.get("skip_trunk"):
            enc = None
        elif cache is not None and "enc" in cache and mode == "decode":
            enc = cache["enc"]
        else:
            enc = self.encode(params, inputs["frames"], ctx=ctx)

        positions = inputs.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        ctx, sp = serving_sequence(ctx, sp, mode, S)
        # a sequence split of the self caches: their whole length, hoisted
        kv_pos = None
        if mode != "dense" and kv_seq_axis(ctx.mesh, ctx.rules) is not None:
            if mode == "decode":
                kv_pos = advance_kv_pos(cache["kv_pos"], positions)
            else:
                kv_pos = prefill_kv_pos(max(int(ctx.extra.get("cache_max_len", S)), S),
                                        positions)
        x = self.embed(whole("embed"), tokens, ctx=ctx)
        x = x + cast(sinusoidal_positions(positions, cfg.d_model), x.dtype)
        x = ctx.constrain(x, ("batch", "res_seq", "embed"))
        split_vocab = params["embed"]["table"].shape[0] != cfg.vocab
        if sp is not None:
            x, positions = sequence_block(x, positions, ctx, sp, split_vocab)

        new_dec_cache = None
        if not ctx.extra.get("skip_trunk"):
            dec_cache = cache.get("decoder") if cache is not None else None
            block_kwargs = {"kv_src": enc}
            if kv_pos is not None and mode == "decode":
                block_kwargs["kv_pos"] = kv_pos
            x, new_dec_cache = self.decoder(
                params["decoder"], x, ctx=ctx, mode=mode, cache=dec_cache,
                positions=positions, block_kwargs=block_kwargs,
                gather=plan and plan["decoder"],
            )
        if mode == "prefill":
            x = last_position(x, ctx, sp)
        x = self.final_norm(whole("final_norm"), x, ctx=ctx)
        entered = sp is not None and mode == "dense" and split_vocab
        if entered:  # the vocab-split logits cover the whole sequence
            x = gather_from(x, ctx.mesh, sp, 1)
        logits = self.embed.attend(whole("embed"), x, ctx=ctx, entered=entered)
        logits = ctx.constrain(logits, ("batch", "res_seq", "vocab"))
        if mode == "dense":
            return logits, None
        new_cache = {"decoder": new_dec_cache, "enc": enc}
        if kv_pos is not None:
            new_cache["kv_pos"] = kv_pos
        return logits, new_cache

    def component_blocks(self, batch: int, cache_len: int):
        """The encoder's and the decoder's block for compositional roofline
        costing: [(name, block_module, count, per_layer_cache_spec,
        kwargs)].  The encoder block has no cache: it does not run at
        decode."""
        cfg = self.cfg
        K, hd = cfg.kv_heads, cfg.resolved_head_dim
        dec_cache = {
            "self": cache_spec(batch, cache_len, K, hd),
            "cross": {
                "ck": ((batch, cache_len, K, hd), torch.bfloat16),
                "cv": ((batch, cache_len, K, hd), torch.bfloat16),
            },
        }
        kv_src = ((batch, cache_len, cfg.d_model), torch.bfloat16)
        return [
            ("enc_block", self.encoder.template, cfg.enc_layers or cfg.num_layers,
             None, {}),
            ("dec_block", self.decoder.template, cfg.num_layers, dec_cache,
             {"kv_src": kv_src}),
        ]

    # -- caches -------------------------------------------------------------------

    def cache_specs(self, batch: int, cache_len: int, enc_len: int | None = None) -> dict:
        """{leaf: (shape, dtype)} cache tree: the decoder's per-layer self
        and cross caches under a leading layer dim, and the encoder states."""
        cfg = self.cfg
        enc_len = enc_len or cache_len
        L, K, hd = cfg.num_layers, cfg.kv_heads, cfg.resolved_head_dim

        def stk(tree):
            if isinstance(tree, dict):
                return {key: stk(value) for key, value in tree.items()}
            shape, dtype = tree
            return ((L, *shape), dtype)

        per_layer = {
            "self": cache_spec(batch, cache_len, K, hd),
            "cross": {
                "ck": ((batch, enc_len, K, hd), torch.bfloat16),
                "cv": ((batch, enc_len, K, hd), torch.bfloat16),
            },
        }
        return {"decoder": stk(per_layer),
                "enc": ((batch, enc_len, cfg.d_model), torch.bfloat16)}

    def init_cache(self, batch: int, cache_len: int, *, index: int = 0,
                   enc_len: int | None = None, device="cpu") -> dict:
        """Concrete zero cache (tests); the self caches' index = `index`."""

        def make(spec):
            if isinstance(spec, dict):
                return {key: make(value) for key, value in spec.items()}
            shape, dtype = spec
            return torch.zeros(shape, dtype=dtype, device=device)

        cache: dict[str, Any] = make(self.cache_specs(batch, cache_len, enc_len))
        cache["decoder"]["self"]["index"] = torch.full(
            (self.cfg.num_layers,), index, dtype=torch.int32, device=device)
        return cache
