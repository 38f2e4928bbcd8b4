"""Decoder LM family — the dense slice of the reference's `TransformerLM`.

  dense : [norm -> attention -> +res ; norm -> MLP -> +res] x L
          (a layer stack in weavable groups)

The MoE, VLM, hybrid (Griffin) and SSM (RWKV6) families raise
`NotImplementedError` until their slices are ported.

Modes: "dense" (full logits), "prefill" (returns last-token logits + KV
cache, or — handed a paged cache — writes the prompt straight into its page
pools), "decode" (S >= 1 tokens against the cache).  Caches are plain dicts
of tensors with a leading per-layer dim per stack; a decode step (and a paged
prefill) updates the cache tensors it is given in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import Attention, cache_spec
from repro_torch.nn.blocks import MLP, Embedding, Linear, RMSNorm
from repro_torch.nn.module import Ctx, Module
from repro_torch.nn.stack import ScannedStack

_LATER_FAMILIES = {
    "moe": "the mixture-of-experts slice",
    "vlm": "the vision-language slice",
    "hybrid": "the recurrentgemma (RG-LRU) slice",
    "ssm": "the RWKV6 slice",
    "encdec": "the encoder-decoder slice",
}


def _make_norm(name: str, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        raise NotImplementedError(
            "LayerNorm is not ported yet (it arrives with the families that use it)")
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


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class TransformerLM(Module):
    kind = "model"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense":
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

        mask = "sliding" if cfg.attn_window else "causal"
        trunk = []
        for gi, n in enumerate(cfg.groups()):
            block = DecoderBlock("block", cfg, mask=mask, window=cfg.attn_window)
            part = ScannedStack(f"blocks{gi}", block, n)
            self.add_module(part.name, part)
            trunk.append(part.name)
        self._trunk_names = tuple(trunk)

    @property
    def trunk(self) -> list[ScannedStack]:
        return [self._modules[n] for n in self._trunk_names]

    def spec(self):
        s: dict[str, Any] = {"embed": self.embed}
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
                attn_kw = {"block_kwargs": shared} if shared else {}
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
        window = cfg.attn_window
        ring = window is not None and window < cache_len
        length = min(window, cache_len) if window else cache_len
        return cache_spec(batch, length, cfg.kv_heads, cfg.resolved_head_dim,
                          ring=ring)

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        """{leaf: (shape, dtype)} cache tree (leading per-layer dim per group)."""
        out: dict[str, Any] = {}
        layer_spec = self._layer_cache_spec(batch, cache_len)
        for part, n in zip(self.trunk, self.cfg.groups()):
            out[part.name] = {key: ((n, *shape), dtype)
                              for key, (shape, dtype) in layer_spec.items()}
        if "pos" not in layer_spec:
            # linear attention caches share one hoisted (B, T) kv_pos
            out["kv_pos"] = ((batch, layer_spec["k"][0][1]), torch.int32)
        return out

    def stack_caches(self, caches: list[dict]) -> dict:
        """Stack per-request (batch=1) decode caches into one batched cache
        — the serving layout: tensor leaves concatenate on their batch axis
        (axis 1 under a stack's layer dim), while the per-stream metadata
        gains a per-request dim: `index` becomes (L, B) and ring `pos`
        (L, B, W).  `Attention._decode` detects the per-request index and
        updates/prunes each request's slots independently (the flash_decode
        kernel loads each request's index itself)."""
        first = caches[0]

        def merge(vals):
            out = {}
            for key in vals[0]:
                arrs = [v[key] for v in vals]
                if key == "index":
                    out[key] = torch.stack(arrs, dim=-1)
                elif key == "pos":
                    out[key] = torch.stack(arrs, dim=1)
                else:
                    out[key] = torch.cat(arrs, dim=1)
            return out

        stacked: dict[str, Any] = {}
        for part in self.trunk:
            vals = [c[part.name] for c in caches]
            stacked[part.name] = None if vals[0] is None else merge(vals)
        if "kv_pos" in first:
            stacked["kv_pos"] = torch.cat([c["kv_pos"] for c in caches], dim=0)
        return stacked

    def init_cache(self, batch: int, cache_len: int, *, index: int = 0,
                   device="cpu") -> dict:
        """Concrete zero cache (tests/examples); index = #valid tokens."""
        cache: dict[str, Any] = {}
        for name, spec in self.cache_specs(batch, cache_len).items():
            if name == "kv_pos":
                shape, dtype = spec
                ar = torch.arange(shape[1], dtype=dtype, device=device)[None]
                cache[name] = torch.where(
                    ar < index, ar, torch.full_like(ar, -1)).expand(shape).contiguous()
                continue
            part = {}
            for key, (shape, dtype) in spec.items():
                fill = {"index": index, "pos": -1}.get(key, 0)
                part[key] = torch.full(shape, fill, dtype=dtype, device=device)
            cache[name] = part
        return cache
