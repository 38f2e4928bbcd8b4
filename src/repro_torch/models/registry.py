"""Architecture registry: configs, reduced smoke configs and model constructors.

Only the architectures whose family is ported are registered — the dense
yi-6b and gemma-2b, the hybrid recurrentgemma-2b and the ssm rwkv6-3b; the
others join as their slices land."""

from __future__ import annotations

import importlib
from typing import Any

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

# Speculative-decoding pairings: target arch -> the small arch that drafts
# for it.  A pairing is only meaningful when the two models share a token
# space (true for the reduced smoke configs, which all use vocab=512).
# Targets absent from this table self-draft.
DRAFTS = {
    "yi-6b": "gemma-2b",
}


def draft_for(name: str) -> str | None:
    """The registry's draft pairing for `name` (None: self-draft)."""
    return DRAFTS.get(name)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    cfg = get_config(name)
    kw: dict[str, Any] = dict(
        num_layers=2, d_model=64, n_heads=4, kv_heads=max(1, min(cfg.kv_heads, 2)),
        head_dim=16, d_ff=128, vocab=512, layer_groups=(),
    )
    if cfg.family == "hybrid":
        kw.update(num_layers=3, lru_width=64, local_window=16, n_heads=4,
                  head_dim=16, kv_heads=1)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16, n_heads=4, kv_heads=4)
    if cfg.attn_window:
        kw.update(attn_window=16)
    return cfg.replace(name=cfg.name + "-reduced", **kw)


def build_model(cfg: ModelConfig):
    from repro_torch.models.lm import TransformerLM

    return TransformerLM(cfg)
