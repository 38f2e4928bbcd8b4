"""Decoder LM family: dense / hybrid (Griffin) / SSM (RWKV6), the reference's
`TransformerLM` without its MoE and VLM families.

  dense  : [norm -> attention -> +res ; norm -> MLP -> +res] x L
           (a layer stack in weavable groups)
  hybrid : recurrentgemma 1:2 pattern (rec, rec, local-attn), unrolled
           (heterogeneous blocks)
  ssm    : RWKV6 time-mix + channel-mix blocks (a layer stack)

The MoE, VLM and encoder-decoder families raise `NotImplementedError` until
their slices are ported.

Modes: "dense" (full logits), "prefill" (returns last-token logits + cache:
KV caches, recurrent states, or — handed a paged cache — the prompt written
straight into its page pools), "decode" (S >= 1 tokens against the cache).
Caches are plain dicts of tensors, with a leading per-layer dim per stack;
a decode step (and a paged prefill) updates the KV cache tensors it is given
in place, while recurrent states come back as new tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import Attention, cache_spec
from repro_torch.nn.blocks import MLP, Embedding, LayerNorm, Linear, RMSNorm
from repro_torch.nn.module import Ctx, Module
from repro_torch.nn.rglru import RecurrentBlock
from repro_torch.nn.rwkv import ChannelMix, TimeMix, rwkv_state_spec
from repro_torch.nn.stack import ScannedStack

_PORTED_FAMILIES = ("dense", "hybrid", "ssm")
_LATER_FAMILIES = {
    "moe": "the mixture-of-experts slice",
    "vlm": "the vision-language slice",
    "encdec": "the encoder-decoder slice",
}


def _make_norm(name: str, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return LayerNorm(name, cfg.d_model)
    return RMSNorm(name, cfg.d_model, plus_one=cfg.norm_plus_one)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class DecoderBlock(Module):
    kind = "block"

    def __init__(self, name: str, cfg: ModelConfig, *, mask: str = "causal",
                 window: int | None = None):
        super().__init__()
        self.name = name
        self.cfg = cfg
        self.norm1 = _make_norm("norm1", cfg)
        self.attn = Attention(
            "attn", cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim,
            bias=cfg.qkv_bias, use_rope=cfg.use_rope, rope_theta=cfg.rope_theta,
            mask=mask, window=window, softcap=cfg.attn_softcap,
        )
        self.norm2 = _make_norm("norm2", cfg)
        self.ffn = MLP(
            "ffn", cfg.d_model, cfg.d_ff, activation=cfg.activation,
            gated=cfg.gated_mlp,
        )

    def spec(self):
        return {"norm1": self.norm1, "attn": self.attn, "norm2": self.norm2,
                "ffn": self.ffn}

    def forward(self, params, x, *, ctx: Ctx, mode="dense", cache=None,
                positions=None, kv_pos=None, block_tables=None, prefix_len=0,
                skip_cache_write=False):
        with ctx.scope(self.name):
            h = self.norm1(params["norm1"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            h, new_cache = self.attn(params["attn"], h, ctx=ctx, positions=positions,
                                     mode=mode, cache=cache, kv_pos=kv_pos,
                                     block_tables=block_tables,
                                     prefix_len=prefix_len,
                                     skip_cache_write=skip_cache_write)
            x = x + h
            h = self.norm2(params["norm2"], x, ctx=ctx)
            h = ctx.constrain(h, ("batch", "seq_act", "embed"))
            h = self.ffn(params["ffn"], h, ctx=ctx)
            x = x + h
            return x, new_cache


class RecBlock(Module):
    """Hybrid temporal-mixing block (RG-LRU) + MLP."""

    kind = "block"

    def __init__(self, name: str, cfg: ModelConfig):
        super().__init__()
        self.name = name
        self.cfg = cfg
        lru = cfg.lru_width or cfg.d_model
        self.norm1 = _make_norm("norm1", cfg)
        self.rec = RecurrentBlock("rec", cfg.d_model, lru, cfg.n_heads)
        self.norm2 = _make_norm("norm2", cfg)
        self.ffn = MLP("ffn", cfg.d_model, cfg.d_ff, activation=cfg.activation,
                       gated=cfg.gated_mlp)

    def spec(self):
        return {"norm1": self.norm1, "rec": self.rec, "norm2": self.norm2,
                "ffn": self.ffn}

    def forward(self, params, x, *, ctx: Ctx, mode="dense", cache=None,
                positions=None):
        with ctx.scope(self.name):
            h = self.norm1(params["norm1"], x, ctx=ctx)
            h, new_state = self.rec(params["rec"], h, ctx=ctx, state=cache, mode=mode)
            x = x + h
            h = self.norm2(params["norm2"], x, ctx=ctx)
            x = x + self.ffn(params["ffn"], h, ctx=ctx)
            if mode == "dense":
                new_state = None
            return x, new_state


class RWKVBlock(Module):
    kind = "block"

    def __init__(self, name: str, cfg: ModelConfig):
        super().__init__()
        self.name = name
        self.cfg = cfg
        self.ln1 = LayerNorm("ln1", cfg.d_model)
        self.time_mix = TimeMix("time_mix", cfg.d_model, cfg.rwkv_head_dim)
        self.ln2 = LayerNorm("ln2", cfg.d_model)
        self.channel_mix = ChannelMix("channel_mix", cfg.d_model, cfg.d_ff)

    def spec(self):
        return {"ln1": self.ln1, "time_mix": self.time_mix, "ln2": self.ln2,
                "channel_mix": self.channel_mix}

    def forward(self, params, x, *, ctx: Ctx, mode="dense", cache=None,
                positions=None):
        with ctx.scope(self.name):
            t_state = cache["time"] if cache is not None else None
            c_state = cache["channel"] if cache is not None else None
            h, t_new = self.time_mix(params["time_mix"],
                                     self.ln1(params["ln1"], x, ctx=ctx),
                                     ctx=ctx, state=t_state, mode=mode)
            x = x + h
            h, c_new = self.channel_mix(params["channel_mix"],
                                        self.ln2(params["ln2"], x, ctx=ctx),
                                        ctx=ctx, state=c_state, mode=mode)
            x = x + h
            new_cache = {"time": t_new, "channel": c_new}
            if mode == "dense":
                new_cache = None
            return x, new_cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class TransformerLM(Module):
    kind = "model"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in _PORTED_FAMILIES:
            later = _LATER_FAMILIES.get(cfg.family, "a later slice")
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet: it arrives "
                f"with {later}")
        self.name = cfg.name.replace("-", "_")
        self.cfg = cfg
        self.embed = Embedding("embed", cfg.vocab, cfg.d_model,
                               scale_by_dim=cfg.embed_scale)
        self.final_norm = _make_norm("final_norm", cfg)
        self.head = (
            None
            if cfg.tie_embeddings
            else Linear("head", cfg.d_model, cfg.vocab, axes=("embed", "vocab"),
                        out_axes=("batch", "seq_act", "vocab"))
        )
        self.ln0 = LayerNorm("ln0", cfg.d_model) if cfg.family == "ssm" else None

        trunk: list[Module] = []
        if cfg.family == "hybrid":
            pat = cfg.block_pattern or ("rec", "rec", "attn")
            for i in range(cfg.num_layers):
                if pat[i % len(pat)] == "attn":
                    trunk.append(DecoderBlock(f"layer{i:02d}", cfg, mask="local",
                                              window=cfg.local_window))
                else:
                    trunk.append(RecBlock(f"layer{i:02d}", cfg))
        else:
            mask = "sliding" if cfg.attn_window else "causal"
            for gi, n in enumerate(cfg.groups()):
                if cfg.family == "ssm":
                    block: Module = RWKVBlock("block", cfg)
                else:
                    block = DecoderBlock("block", cfg, mask=mask, window=cfg.attn_window)
                trunk.append(ScannedStack(f"blocks{gi}", block, n))
        for part in trunk:
            self.add_module(part.name, part)
        self._trunk_names = tuple(part.name for part in trunk)

    @property
    def trunk(self) -> list[Module]:
        """Layer stacks (dense, ssm) or the unrolled blocks (hybrid)."""
        return [self._modules[n] for n in self._trunk_names]

    def spec(self):
        s: dict[str, Any] = {"embed": self.embed}
        if self.ln0 is not None:
            s["ln0"] = self.ln0
        for part in self.trunk:
            s[part.name] = part
        s["final_norm"] = self.final_norm
        if self.head is not None:
            s["head"] = self.head
        return s

    # -- forward -----------------------------------------------------------------

    def forward(self, params, inputs: dict, *, ctx: Ctx, mode: str = "dense",
                cache: dict | None = None, prefix_len: int = 0,
                skip_cache_write: bool = False):
        tokens = inputs["tokens"]
        B = tokens.shape[0]
        x = self.embed(params["embed"], tokens, ctx=ctx)
        if self.ln0 is not None:
            x = self.ln0(params["ln0"], x, ctx=ctx)
        x = ctx.constrain(x, ("batch", "res_seq", "embed"))

        S = x.shape[1]
        positions = inputs.get("positions")
        if positions is None:
            if mode == "decode":
                raise ValueError("decode mode requires explicit positions")
            if prefix_len:
                raise ValueError("paged prefill with a shared prefix needs "
                                 "explicit (prefix-offset) positions")
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

        new_caches: dict[str, Any] = {}
        # Hoisted linear-cache decode positions: updated ONCE per step (an
        # O(B·S) scatter on the cached (B, T) kv_pos, in place) and shared by
        # every attention layer — instead of each layer re-deriving an
        # arange(T) mask broadcast to (B, T).  Paged caches hoist their
        # block tables the same way: one (B, NB) page map, uploaded once per
        # step, shared by every layer (the per-layer pools index the same
        # physical page space) — in decode mode and in paged prefill.
        kv_pos = None
        block_tables = None
        if mode == "decode" and cache is not None and "kv_pos" in cache:
            kv_pos = cache["kv_pos"]
            T = kv_pos.shape[1]
            # positions past the cache's end are dropped, as the reference's
            # scatter does: they are pointed at their old contents instead
            pos = positions.to(torch.long)
            ok = (pos >= 0) & (pos < T)
            safe = torch.where(ok, pos, torch.zeros_like(pos))
            rows = torch.arange(B, device=x.device)[:, None].expand_as(pos)
            kv_pos[rows, safe] = torch.where(
                ok, positions.to(kv_pos.dtype), kv_pos[rows, safe])
            new_caches["kv_pos"] = kv_pos
        if mode in ("decode", "prefill") and cache is not None \
                and "block_tables" in cache:
            block_tables = cache["block_tables"]
            new_caches["block_tables"] = block_tables
        shared: dict[str, Any] = {}
        if kv_pos is not None:
            shared["kv_pos"] = kv_pos
        if block_tables is not None:
            shared["block_tables"] = block_tables
            if mode == "prefill":
                shared["prefix_len"] = prefix_len
        if skip_cache_write:
            # threaded unconditionally: a re-score step against a table-less
            # (dense) cache must reach Attention's contract guard, not
            # silently write the cache
            shared["skip_cache_write"] = True
        if not ctx.extra.get("skip_trunk"):
            for part in self.trunk:
                part_cache = None if cache is None else cache.get(part.name)
                attn_kw: dict[str, Any] = {}
                if shared and isinstance(part, ScannedStack) \
                        and isinstance(part.template, DecoderBlock):
                    attn_kw = {"block_kwargs": shared}
                elif shared and isinstance(part, DecoderBlock):
                    attn_kw = shared
                x, c = part(params[part.name], x, ctx=ctx, mode=mode,
                            cache=part_cache, positions=positions, **attn_kw)
                new_caches[part.name] = c
        if mode == "prefill":
            kvp = self._prefill_kv_pos(new_caches, positions)
            if kvp is not None:
                new_caches["kv_pos"] = kvp

        if mode == "prefill":
            x = x[:, -1:]
        x = self.final_norm(params["final_norm"], x, ctx=ctx)
        if self.head is not None:
            logits = self.head(params["head"], x, ctx=ctx)
        else:
            logits = self.embed.attend(params["embed"], x, ctx=ctx)
        logits = ctx.constrain(logits, ("batch", "res_seq", "vocab"))
        if mode == "dense":
            return logits, None
        return logits, new_caches

    # -- caches -------------------------------------------------------------------

    @staticmethod
    def _prefill_kv_pos(new_caches, positions):
        """(B, T) slot->position map for the *linear* attention caches, built
        once at prefill and carried in the cache dict (slot s holds position
        s for s < S, -1 beyond).  Ring caches carry their own `pos` and need
        no shared map."""
        for c in new_caches.values():
            if isinstance(c, dict) and "k" in c and "pos" not in c:
                T = c["k"].shape[-3]  # (..., B, T, K, D)
                ar = torch.arange(T, dtype=torch.int32, device=positions.device)[None]
                last = positions[:, -1:].to(torch.int32)
                return torch.where(ar <= last, ar, torch.full_like(ar, -1))
        return None

    def _layer_cache_spec(self, batch: int, cache_len: int):
        cfg = self.cfg
        if cfg.family == "ssm":
            return rwkv_state_spec(batch, cfg.d_model, cfg.rwkv_head_dim)
        window = cfg.attn_window
        ring = window is not None and window < cache_len
        length = min(window, cache_len) if window else cache_len
        return cache_spec(batch, length, cfg.kv_heads, cfg.resolved_head_dim,
                          ring=ring)

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        """{leaf: (shape, dtype)} cache tree (leading per-layer dim per stack;
        the unrolled hybrid blocks have none)."""
        cfg = self.cfg
        out: dict[str, Any] = {}
        if cfg.family == "hybrid":
            for part in self.trunk:
                if isinstance(part, RecBlock):
                    out[part.name] = RecurrentBlock.state_spec(
                        batch, cfg.lru_width or cfg.d_model)
                else:
                    W = min(cfg.local_window, cache_len)
                    ring = cfg.local_window < cache_len
                    out[part.name] = cache_spec(
                        batch, W, cfg.kv_heads, cfg.resolved_head_dim, ring=ring)
                    if not ring:
                        out["kv_pos"] = ((batch, W), torch.int32)
            return out

        def stack(tree, n):
            if isinstance(tree, dict):
                return {key: stack(value, n) for key, value in tree.items()}
            shape, dtype = tree
            return ((n, *shape), dtype)

        layer_spec = self._layer_cache_spec(batch, cache_len)
        for part, n in zip(self.trunk, cfg.groups()):
            out[part.name] = stack(layer_spec, n)
        if "k" in layer_spec and "pos" not in layer_spec:
            # linear attention caches share one hoisted (B, T) kv_pos
            out["kv_pos"] = ((batch, layer_spec["k"][0][1]), torch.int32)
        return out

    def stack_caches(self, caches: list[dict]) -> dict:
        """Stack per-request (batch=1) decode caches into one batched cache
        — the serving layout: tensor leaves concatenate on their batch axis
        (axis 1 under a stack's layer dim, else 0), while the per-stream
        metadata gains a per-request dim: `index` becomes (..., B) and ring
        `pos` (..., B, W).  `Attention._decode` detects the per-request index
        and updates/prunes each request's slots independently (the
        flash_decode kernel loads each request's index itself).

        Under a window, prompts longer than it prefill into ring caches and
        shorter ones into linear caches; where one batch holds both, the
        linear caches join in the ring layout (`_linear_to_ring`).  The
        reference cannot stack that mix (its concatenation of the two
        layouts fails)."""
        first = caches[0]
        rung = False  # some linear caches joined as rings: no linear cache is left

        def merge(vals, scanned: bool):
            nonlocal rung
            if "k" in vals[0] and any("pos" in v for v in vals):
                W = next(v["k"].shape[-3] for v in vals if "pos" in v)
                rung = rung or not all("pos" in v for v in vals)
                vals = [v if "pos" in v else _linear_to_ring(v, W) for v in vals]
            out = {}
            for key in vals[0]:
                arrs = [v[key] for v in vals]
                if isinstance(arrs[0], dict):
                    out[key] = merge(arrs, scanned)
                elif key == "index":
                    out[key] = torch.stack(arrs, dim=-1)
                elif key == "pos":
                    out[key] = torch.stack(arrs, dim=1 if scanned else 0)
                else:
                    out[key] = torch.cat(arrs, dim=1 if scanned else 0)
            return out

        stacked: dict[str, Any] = {}
        for part in self.trunk:
            vals = [c[part.name] for c in caches]
            stacked[part.name] = None if vals[0] is None else merge(
                vals, isinstance(part, ScannedStack))
        if not rung and "kv_pos" in first:
            stacked["kv_pos"] = torch.cat([c["kv_pos"] for c in caches], dim=0)
        return stacked

    def init_cache(self, batch: int, cache_len: int, *, index: int = 0,
                   device="cpu") -> dict:
        """Concrete zero cache (tests/examples); index = #valid tokens."""

        def make(spec):
            out = {}
            for key, value in spec.items():
                if isinstance(value, dict):
                    out[key] = make(value)
                    continue
                shape, dtype = value
                fill = {"index": index, "pos": -1}.get(key, 0)
                out[key] = torch.full(shape, fill, dtype=dtype, device=device)
            return out

        cache: dict[str, Any] = {}
        for name, spec in self.cache_specs(batch, cache_len).items():
            if name == "kv_pos":
                shape, dtype = spec
                ar = torch.arange(shape[1], dtype=dtype, device=device)[None]
                cache[name] = torch.where(
                    ar < index, ar, torch.full_like(ar, -1)).expand(shape).contiguous()
                continue
            cache[name] = make(spec)
        return cache


def _linear_to_ring(cache: dict, W: int) -> dict:
    """A linear attention cache whose prompt fits the window (index <= W)
    in the ring layout of W slots: slot s holds position s, as the ring puts
    it (s % W == s), and the unwritten slots are marked empty (pos -1).
    Under a stack's layer dim `index` is (L,) and the slot axis is 2."""
    idx = cache["index"]
    if bool((idx > W).any()):
        raise ValueError(f"a linear cache holding {idx.tolist()} tokens does not "
                         f"fit a ring of {W} slots")
    slots = cache["k"].dim() - 3  # (..., B, T, K, D)
    k = cache["k"].narrow(slots, 0, W)
    v = cache["v"].narrow(slots, 0, W)
    ar = torch.arange(W, dtype=torch.int32, device=idx.device)
    limit = idx.to(torch.int32)[..., None]
    pos = torch.where(ar < limit, ar, torch.full_like(ar, -1))
    return {"k": k, "v": v, "pos": pos, "index": idx}
